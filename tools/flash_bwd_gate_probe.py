"""How the flash-attention backward's bf16 gate reads, on one card.

    python tools/flash_bwd_gate_probe.py

Prints one JSON line per row of chip_smoke.py's flash_attention_bwd rows
with its errors (against the plain version, and by RMS against the exact
gradient beside the plain bf16 version's own), times and the faults
chip_smoke.py would raise for (listed here, not raised). Then, at
gemma2-9b's heads ([1, 4096, 16, 8, 256], bf16, causal, softcap 50) with
q drawn at 1 and at 30 times N(0, 1), one line for a stand-in of a kernel
that drops the softcap factor 1 - (s/cap)^2: the plain version with
tanh's gradient set to 1, read by the same measures. It shows what the
gate can see: a ratio above ref.BF16_GRAD_RMS_RATIO fails it.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

KEYS = ("variant", "dtype", "row_scaled_err", "fp32_plain_row_scaled_err",
        "plain_fp32_row_scaled_err", "rms_err", "plain_rms_err",
        "rms_err_ratio", "rel_err", "ms", "device_ms", "plain_ms",
        "library_ms", "bound_ms", "bitwise_repeatable", "launches",
        "kv_splits")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_gate_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.nvidia_smi(), flush=True)
    rows()
    for q_scale in (1.0, 30.0):
        dropped_softcap_factor(q_scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
