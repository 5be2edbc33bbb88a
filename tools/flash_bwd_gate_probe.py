"""How the flash-attention backward's bf16 gate reads, on one card, and
how its time compares with another build's.

    python tools/flash_bwd_gate_probe.py
    python tools/flash_bwd_gate_probe.py --baseline FILE.cu [FILE.cu ...]
                                         [--rows VARIANT ...] [--reps 5]

Prints one JSON line per row of chip_smoke.py's flash_attention_bwd rows
with its errors (against the plain version, and by RMS against the exact
gradient beside the plain bf16 version's own), times and the faults
chip_smoke.py would raise for (listed here, not raised). Then, at
gemma2-9b's heads ([1, 4096, 16, 8, 256], bf16, causal, softcap 50) with
q drawn at 1 and at 30 times N(0, 1), one line for a stand-in of a kernel
that drops the softcap factor 1 - (s/cap)^2: the plain version with
tanh's gradient set to 1, read by the same measures. It shows what the
gate can see: a ratio above ref.BF16_GRAD_RMS_RATIO fails it.

--baseline builds a second library from other sources (for example the
parent commit's flash_attention.cu and flash_attention_bwd.cu, saved under
build/, which is gitignored and copied to the card) and prints instead,
after both builds' registers and spills (-Xptxas -v), one JSON line per
row of chip_smoke.BWD_ROWS (--rows keeps the named ones): CUDA-event ms
of the package's backward and the baseline's in turns (baseline, kernel,
kernel, baseline; --reps calls each after one warm-up), each kernel's
device ms from the profiler, the bound, and how far the two builds'
gradients are apart.  A baseline with the package's entry point
(flash_attention_grad_launch) runs through attend_bwd(lib=); one with the
earlier entry point (flash_attention_bwd_launch, which computed its own
row statistics from the bf16 output) through ``earlier_bwd``.
"""
import argparse
import ctypes
import json
import shutil
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
from repro_torch.kernels.flash_attention import flash_attention as K  # noqa
from repro_torch.kernels.flash_attention import ref  # noqa: E402

KEYS = ("variant", "dtype", "row_scaled_err", "fp32_plain_row_scaled_err",
        "plain_fp32_row_scaled_err", "rms_err", "plain_rms_err",
        "rms_err_ratio", "rel_err", "ms", "device_ms", "plain_ms",
        "library_ms", "bound_ms", "bitwise_repeatable", "launches",
        "kv_splits", "lse_rel_err", "out32_row_scaled_err")
NAMES = ("dq", "dk", "dv")
TANH = torch.tanh


class StraightTanh(torch.autograd.Function):
    """tanh forward, the identity's gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return TANH(x)

    @staticmethod
    def backward(ctx, g):
        return g


def rows() -> None:
    faults = []
    check = CS.bwd_row_faults
    CS.bwd_row_faults = lambda row: faults.append(check(row)) or []
    try:
        got = CS.flash_bwd_rows(0)
    finally:
        CS.bwd_row_faults = check
    for r, f in zip(got, faults):
        print(json.dumps({k: r.get(k) for k in KEYS} | {"faults": f}),
              flush=True)


def dropped_softcap_factor(q_scale: float) -> None:
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, dout = (torch.randn((1, 4096, h, 256), generator=g,
                                 device="cuda") for h in (16, 8, 8, 16))
    q, k, v, dout = (t.bfloat16() for t in (q * q_scale, k, v, dout))
    kw = dict(causal=True, softcap=50.0)
    exact = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        None, dout.float(), **kw)
    plain = ref.flash_attention_bwd_ref(q, k, v, None, dout, **kw)
    torch.tanh = StraightTanh.apply
    try:
        wrong = ref.flash_attention_bwd_ref(q, k, v, None, dout, **kw)
    finally:
        torch.tanh = TANH
    print(json.dumps({
        "stand_in": "softcap factor dropped", "q_scale": q_scale,
        "rms_err_ratio": {n: ref.grad_rms_err(w, e) / ref.grad_rms_err(p, e)
                          for n, w, p, e in zip(NAMES, wrong, plain, exact)},
        "row_scaled_err": {n: ref.grad_row_err(w, p)
                           for n, w, p in zip(NAMES, wrong, plain)}}),
        flush=True)
    torch.cuda.empty_cache()


def build_baseline(sources) -> Path:
    """Compile ``sources`` alone into their own library under build/."""
    csrc = _build.BUILD_ROOT / "flash_bwd_baseline_src"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for src in sources:
        shutil.copyfile(src, csrc / Path(src).name)
    return _build.build("flash_bwd_baseline", csrc)


def earlier_bwd(lib, q, k, v, out, dout, *, causal, window, softcap,
                positions, **_):
    """(dq, dk, dv) from a build with the earlier entry point,
    flash_attention_bwd_launch: the same views, its own scratch (three
    fp32 row statistics; key tiles of 8192 / D keys for bf16, 32 for
    fp32; position bounds over 32-key and 64-row tiles)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [p] * 8 + [i] * 6 + [p, f, f, i, i, i, p, p, p, p, i, p]
    fn.restype = ctypes.c_int
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = K.kv_splits(B, KV, Sk, H // KV, sms, 8192 // D if bf16 else 32)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty(3 * B * H * Sq, **f32)
    partials = torch.empty(2 * nsplit * B * Sk * KV * D if nsplit > 1
                           else 0, **f32)
    bounds = torch.empty(2 * (-(-Sk // 32) + -(-Sq // 64))
                         if positions is not None else 0,
                         dtype=torch.int32, device=q.device)
    views = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_int64 * 24)(*(s for t in views
                                      for s in t.stride()[:3]))
    err = fn(*(t.data_ptr() for t in views), B, H, KV, Sq, Sk, D,
             ctypes.cast(strides, ctypes.c_void_p), float(D ** -0.5),
             float(softcap), int(causal), int(window), int(bf16),
             positions.data_ptr() if positions is not None else None,
             bounds.data_ptr(), stats.data_ptr(), partials.data_ptr(),
             nsplit, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier backward failed with CUDA error {err}")
    return dq, dk, dv


def turns(args) -> None:
    builds = {"flash_attention": K.build,
              "flash_bwd_baseline": partial(build_baseline, args.baseline)}
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        paths = dict(zip(builds, pool.map(lambda b: b(), builds.values())))
    for name in builds:
        info = _build.build_info[name]
        print(name, "nvcc seconds", info["seconds"], flush=True)
        print("\n".join(ln for ln in CS.ptxas_lines(str(info["log"]))
                        if "bwd" in ln or "spill" in ln or "Used" in ln
                        or "Performance" in ln), flush=True)
    base = K.load(paths["flash_bwd_baseline"])
    for row in CS.BWD_ROWS:
        variant, dtype, S, (H, KV, D) = row[:4]
        B = row[9]
        if args.rows and variant not in args.rows:
            continue
        q, k, v, dout, out, kw = CS.bwd_inputs(args.seed, row)
        calls = {"kernel": partial(K.attend_bwd, q, k, v, out, dout, **kw)}
        if hasattr(base, "flash_attention_grad_launch"):
            calls["baseline"] = partial(K.attend_bwd, q, k, v, out, dout,
                                        lib=base, **kw)
        else:
            calls["baseline"] = partial(earlier_bwd, base, q, k, v, out,
                                        dout, **kw)
        got = {n: c() for n, c in calls.items()}
        diff = {n: float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())
                for n, a, b in zip(("dq", "dk", "dv"), got["kernel"],
                                   got["baseline"])}
        del got
        line = {"variant": variant, "dtype": dtype, "shape": [B, S, H, KV, D],
                "rel_diff_to_baseline": diff}
        for name in ("baseline", "kernel", "kernel", "baseline"):
            line.setdefault(f"{name}_ms", []).append(
                CS.cuda_ms(calls[name], args.reps))
        for name, call in calls.items():
            line[f"{name}_device_kernels_ms"] = CS.kernel_device_ms(
                call, args.reps, "flash_bwd_")["device_kernels_ms"]
        print(json.dumps(line), flush=True)
        del q, k, v, dout, out, kw, calls
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, nargs="+")
    ap.add_argument("--rows", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_gate_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.nvidia_smi(), flush=True)
    if args.baseline:
        turns(args)
        print(CS.nvidia_smi(), flush=True)
        return 0
    rows()
    for q_scale in (1.0, 30.0):
        dropped_softcap_factor(q_scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
