"""Build the ssd_scan CUDA kernels and time them alone on one card.

    python tools/ssd_scan_probe.py [--baseline FILE.cu [FILE.cu ...]]
                                   [--rows VARIANT ...] [--reps 5] [--seed 0]

Prints the card (nvidia-smi: name, power limit, SM clock, power draw,
temperature) before and after, the nvcc seconds and ptxas's registers,
spills and performance notes of each library, then one JSON line per row
of chip_smoke.py's ssd_scan rows (mamba2-780m's widths: 48 heads of 64,
state 128, chunk 256; fp32 [1, 4096], bf16 [1, 32768] and bf16 at the main
path's [4, 32768]; and jamba-1.5-large-398b's 256 heads, bf16 [1, 8192])
on inputs drawn as chip_smoke.py draws them from
--seed: the path the wrapper takes, the error (max |got - want| / max
|want| for y and h_final) against the plain version run in fp32 on the
upcast inputs, the bound, and CUDA-event milliseconds per call (mean of
--reps calls after one warm-up) of the kernel and of the plain version;
on the wgmma path also each pass's CUDA-event milliseconds (events
recorded between the passes' launches, mean over --reps calls).
Then one JSON line per row of chip_smoke.py's ssd_scan_bwd rows (the
backward at mamba2-780m's training shape, bf16 [1, 4096], and fp32
[1, 1024], dh_final None, from the forward's statistics): the path
(bwd_path), the error of each gradient against the plain version (bf16:
ref.ssd_passes_bwd with the rounding of the path taken; fp32: autograd
through ref.ssd_chunked), the bound, CUDA-event milliseconds of the kernel
and of the plain version, and each backward kernel's device milliseconds
(profiler), for each build.
--rows keeps only the named rows (prefill_bf16, fp32, main_path, jamba,
bwd_train_bf16, bwd_fp32).

--baseline builds a second library from other sources (for example the
parent commit's ssd_scan.cu, saved under build/, which is gitignored and
copied to the card) and times it in turns with the package's kernels on
the same inputs: baseline, kernel, kernel, baseline, and says whether
the two builds' y and h_final are bitwise equal.  A baseline that has
the passes' entry points takes the same path as the package; one built
from ssd_scan.cu alone (whose entry point ssd_scan_launch keeps its
signature) runs its one kernel.  A baseline with the backward's entry
point (ssd_scan_bwd.cu built with ssd_scan.cu and ssd_passes.cu) is timed
in turns on the backward rows too, on the wgmma backward where it has
ssd_scan_bwd_wgmma.cu's entry point and the row takes that path, else on
the simple one (an earlier build: the fp32 FMA kernels); one without a
backward sits those rows out.
A quick check of a kernel change; chip_smoke.py is the full run.
"""
import argparse
import importlib
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build as _build  # noqa: E402
SS = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked, ssd_passes_bwd,
)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_baseline(sources) -> Path:
    """Compile ``sources`` alone into their own library under build/."""
    csrc = _build.BUILD_ROOT / "ssd_scan_baseline_src"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for src in sources:
        shutil.copyfile(src, csrc / Path(src).name)
    return _build.build("ssd_scan_baseline", csrc)


def pass_ms(args, lib, reps: int) -> dict:
    """CUDA-event milliseconds of each pass of the wgmma path, the mean
    over ``reps`` calls after one warm-up."""
    names = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
    SS.passes(*args, chunk=CS.SSD_CHUNK, lib=lib)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        events = []
        SS.passes(*args, chunk=CS.SSD_CHUNK, lib=lib, events=events)
        runs.append(events)
    torch.cuda.synchronize()
    return {name: sum(ev[i].elapsed_time(ev[i + 1]) for ev in runs) / reps
            for i, name in enumerate(names)}


def bwd_rows(libs, order, args) -> None:
    """chip_smoke.py's ssd_scan_bwd rows, each build in turns."""
    names = ("dxh", "ddt", "dA", "dBc", "dCc", "dD")
    libs = {n: lib for n, lib in libs.items()
            if hasattr(lib, "ssd_scan_bwd_launch")}
    order = [n for n in order if n in libs]
    for i, (variant, dtype, B, S) in enumerate(CS.SSD_BWD_ROWS):
        variant = f"bwd_{variant}"
        if args.rows and variant not in args.rows:
            continue
        inputs = CS.ssd_inputs(B, S, getattr(torch, dtype), args.seed + 10 + i)
        g = torch.Generator(device="cuda").manual_seed(args.seed + 20 + i)
        dy = torch.randn(inputs[0].shape, generator=g,
                         device="cuda").to(inputs[0].dtype)
        _, _, h_before = SS.scan(*inputs, chunk=CS.SSD_CHUNK, stats=True)
        path = SS.bwd_path(inputs[0], inputs[3], inputs[4], dy, CS.SSD_CHUNK)
        if dtype == "bfloat16":
            plain = partial(ssd_passes_bwd, *inputs, dy, None, CS.SSD_CHUNK,
                            operand_dtype=torch.bfloat16, path=path)
        else:
            def plain():
                leaves = [a.detach().requires_grad_() for a in inputs]
                y, _ = ssd_chunked(*leaves, CS.SSD_CHUNK)
                return torch.autograd.grad(y, leaves, dy)
        want = plain()
        row = {"variant": variant, "dtype": dtype,
               "shape": [B, S, CS.SSD_HEADS, CS.SSD_HEAD_DIM, CS.SSD_STATE],
               "chunk": CS.SSD_CHUNK, "path": path}
        calls, outs = {}, {}
        for name, lib in libs.items():
            run = path if hasattr(lib, "ssd_scan_bwd_wgmma_launch") \
                else "simple"
            row[f"{name}_path"] = run
            calls[name] = partial(SS.scan_bwd, *inputs, dy, None, h_before,
                                  chunk=CS.SSD_CHUNK, lib=lib, path=run)
            outs[name] = calls[name]()
            row[f"{name}_rel_err"] = {
                n: float((a.float() - w.float()).abs().max()
                         / w.float().abs().max())
                for n, a, w in zip(names, outs[name], want)}
        if "baseline" in libs:
            row["bitwise_equal_to_baseline"] = all(
                bool(torch.equal(a, b))
                for a, b in zip(outs["kernel"], outs["baseline"]))
        del want, outs
        torch.cuda.empty_cache()
        for name in order:
            row.setdefault(f"{name}_ms", []).append(
                CS.cuda_ms(calls[name], args.reps))
        row["plain_ms"] = CS.cuda_ms(plain, 2)
        for name in libs:
            dev = CS.kernel_device_ms(calls[name], args.reps,
                                      CS.SSD_BWD_KERNELS)
            row.update({(k if name == "kernel" else f"{name}_{k}"): v
                        for k, v in dev.items()})
        elem = inputs[0].element_size()
        H, P, N = CS.SSD_HEADS, CS.SSD_HEAD_DIM, CS.SSD_STATE
        nbytes = (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * N
                  + 4 * H) * elem + B * (S // CS.SSD_CHUNK) * H * P * N * 4
        row["bound_ms"], row["bound_by"] = CS.bound(
            nbytes, CS.ssd_bwd_ops(B, S), CS.FLOPS_PER_S[dtype])
        print(json.dumps(row), flush=True)
        del inputs, calls, dy, h_before
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, nargs="+")
    ap.add_argument("--rows", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"ssd_scan": SS.build}
    if args.baseline:
        builds["ssd_scan_baseline"] = partial(build_baseline, args.baseline)
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        paths = dict(zip(builds, pool.map(lambda b: b(), builds.values())))
    for name in builds:
        info = _build.build_info[name]
        print(name, "nvcc seconds", info["seconds"], flush=True)
        print("\n".join(CS.ptxas_lines(str(info["log"]))), flush=True)
    libs = {"kernel": SS.load(paths["ssd_scan"])}
    if args.baseline:
        libs["baseline"] = SS.load(paths["ssd_scan_baseline"])
    order = ["baseline", "kernel", "kernel", "baseline"] if args.baseline \
        else ["kernel", "kernel"]

    for i, (variant, dtype, B, S, tol, H) in enumerate(CS.SSD_ROWS):
        if args.rows and variant not in args.rows:
            continue
        inputs = CS.ssd_inputs(B, S, getattr(torch, dtype), args.seed + i, H)
        path = SS.wgmma_path(inputs[0], inputs[3], inputs[4], CS.SSD_CHUNK)
        want_y, want_h = ssd_chunked(*(a.float() for a in inputs),
                                     CS.SSD_CHUNK)
        row = {"variant": variant, "dtype": dtype,
               "shape": [B, S, H, CS.SSD_HEAD_DIM, CS.SSD_STATE],
               "chunk": CS.SSD_CHUNK, "path": path, "tol": tol}
        calls, outs = {}, {}
        for name, lib in libs.items():
            run = "wgmma" if path == "wgmma" and hasattr(
                lib, "ssd_chunk_state_launch") else "simple"
            calls[name] = partial(SS.scan, *inputs, chunk=CS.SSD_CHUNK,
                                  lib=lib, path=run)
            y, h = outs[name] = calls[name]()
            row[f"{name}_path"] = run
            row[f"{name}_rel_err"] = {
                "y": float((y.float() - want_y).abs().max()
                           / want_y.abs().max()),
                "h_final": float((h - want_h).abs().max()
                                 / want_h.abs().max())}
            del y, h
        if args.baseline:
            row["bitwise_equal_to_baseline"] = all(
                bool(torch.equal(a, b))
                for a, b in zip(outs["kernel"], outs["baseline"]))
        del want_y, want_h, outs
        torch.cuda.empty_cache()
        for name in order:
            row.setdefault(f"{name}_ms", []).append(
                CS.cuda_ms(calls[name], args.reps))
        row["plain_ms"] = CS.cuda_ms(
            partial(ssd_chunked, *inputs, CS.SSD_CHUNK), 2)
        if path == "wgmma":
            row["kernel_pass_ms"] = pass_ms(inputs, libs["kernel"],
                                            args.reps)
        elem = inputs[0].element_size()
        P, N = CS.SSD_HEAD_DIM, CS.SSD_STATE
        nbytes = (2 * B * S * H * P + B * S * H + 2 * B * S * N + 2 * H) \
            * elem + B * H * P * N * 4
        row["bound_ms"], row["bound_by"] = CS.bound(
            nbytes, CS.ssd_ops(B, S, H), CS.FLOPS_PER_S[dtype])
        print(json.dumps(row), flush=True)
        del inputs, calls
        torch.cuda.empty_cache()
    bwd_rows(libs, order, args)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
