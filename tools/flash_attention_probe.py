"""Build the flash_attention CUDA kernel and time it alone on one card.

    python tools/flash_attention_probe.py [--baseline FILE.cu] [--reps 10]

Prints the card (nvidia-smi: name, power limit, SM clock, power draw,
temperature) before and after, the nvcc seconds and ptxas's registers and
spills of each library, then one JSON line per row of chip_smoke.py's
flash_attention rows (gemma2-9b's prefill: 16 q heads, 8 KV heads, D 256;
bf16 [1, 8192] local, global and causal, fp32 [1, 1024] global;
qwen3-moe-30b-a3b's: 32 q heads, 4 KV heads, D 128, bf16 [1, 4096] causal;
and hubert-xlarge's: 16 heads of 80, bidirectional, bf16 [1, 32768] and
fp32 [1, 1024]) on inputs drawn from --seed: max abs and row-scaled error
against the plain version, the bound, and CUDA-event milliseconds per
call (mean of --reps calls after one warm-up) of the kernel and of one
PyTorch call of the same function (scaled_dot_product_attention for the
rows without a softcap, compiled FlexAttention for the softcap rows), a
yardstick the port never calls.

--baseline builds a second library from another flash_attention.cu (for
example the parent commit's, saved under build/, which is gitignored and
copied to the card) and times it in turns with the package's kernel on the
same inputs: baseline, kernel, kernel, baseline, and says whether the two
outputs are bitwise equal.  A quick check of a kernel change;
chip_smoke.py is the full run.
"""
import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build as _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402,E501
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    row_scaled_err,
)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_baseline(source: Path) -> Path:
    """Compile ``source`` alone into its own library under build/."""
    csrc = _build.BUILD_ROOT / "flash_attention_baseline_src"
    csrc.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(source, csrc / "flash_attention.cu")
    return _build.build("flash_attention_baseline", csrc)


def errors(got, want) -> dict:
    return {"max_abs_err": float((got.float() - want.float()).abs().max()),
            "row_scaled_err": row_scaled_err(got, want)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    builds = {"flash_attention": FA.build}
    if args.baseline:
        builds["flash_attention_baseline"] = partial(build_baseline,
                                                     args.baseline)
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        paths = dict(zip(builds, pool.map(lambda b: b(), builds.values())))
    for name in builds:
        info = _build.build_info[name]
        print(name, "nvcc seconds", info["seconds"], flush=True)
        print("\n".join(CS.ptxas_lines(str(info["log"]))), flush=True)
    libs = {"kernel": FA.load(paths["flash_attention"])}
    if args.baseline:
        libs["baseline"] = FA.load(paths["flash_attention_baseline"])
    order = ["baseline", "kernel", "kernel", "baseline"] if args.baseline \
        else ["kernel", "kernel"]

    for variant, dtype, B, S, causal, window, cap, tol, (H, KV, D) in \
            CS.FLASH_ROWS:
        rng = np.random.default_rng([args.seed, S, window, int(cap)])
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, h, D), dtype=np.float32)).to("cuda", getattr(torch, dtype))
            for h in (H, KV, KV))
        kw = dict(causal=causal, window=window, softcap=cap)
        want = CS.plain_flash(q, k, v, **kw)
        row = {"variant": variant, "dtype": dtype, "shape": [B, S, H, KV, D],
               **kw, "tol": tol}
        calls, outs = {}, {}
        for name, lib in libs.items():
            calls[name] = partial(FA.attend, q, k, v, lib=lib, **kw)
            outs[name] = calls[name]()
            row[name] = errors(outs[name], want)
        if args.baseline:
            row["bitwise_equal_to_baseline"] = bool(
                torch.equal(outs["kernel"], outs["baseline"]))
        torch.cuda.synchronize()
        del outs
        del want
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if cap:
            row["library"] = "flex_attention"
            calls["library"] = partial(CS.flex_attention_call(S, window, cap),
                                       qt, kt, vt)
        else:
            row["library"] = "scaled_dot_product_attention"
            calls["library"] = partial(
                torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                is_causal=causal, enable_gqa=True)
        for name in order + ["library"]:
            row.setdefault(f"{name}_ms", []).append(
                CS.cuda_ms(calls[name], args.reps))
        pairs = B * CS.live_pairs(S, causal, window)
        row["bound_ms"], row["bound_by"] = CS.bound(
            B * (2 * H + 2 * KV) * S * D * q.element_size(), 4 * H * D * pairs,
            CS.FLOPS_PER_S[dtype])
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt, calls
        torch.cuda.empty_cache()
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
