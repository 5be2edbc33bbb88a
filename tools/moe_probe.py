"""Run chip_smoke.py's phases of one served MoE config alone on one card.

    python tools/moe_probe.py [--arch qwen3-moe-30b-a3b | grok-1-314b]
                              [--seed 0]

Builds the flash_attention kernel, then prints one JSON line each for
chip_smoke.py's flash_attention row at the config's prefill shape (kernel
against its plain version, bound, SDPA) and its three phases through
chip_smoke.moe_phases: qwen3-moe-30b-a3b's moe_model (bf16 parameters, a
timed prefill of [1, 4096] launching flash_attention 48 times, 8 requests
served and read back), moe_trace with the device-time breakdown by MoE
part and moe_parity; or grok-1-314b's grok_model (full width cut to 6
layers, bf16, [1, 8192], 6 launches), grok_trace and grok_parity (the
kernels against the plain versions too); the card's name and power limit
first.  The quick check of a change to the MoE path (about 100 s of
command for qwen3-moe) before a whole chip_smoke.py, which runs the same
phases after the store's and the other models'.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

#: each arch's flash row in chip_smoke.FLASH_ROWS and its phases' tag in
#: chip_smoke.MOE_SERVE
ARCHS = {CS.MOE_ARCH: ("qwen3_moe", "moe"), CS.GROK_ARCH: ("grok", "grok")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), default=CS.MOE_ARCH)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # IEEE fp32 for every fp32 product, as chip_smoke.py sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.nvidia_smi(), flush=True)
    start = time.perf_counter()
    flash_attention.build()
    variant, tag = ARCHS[args.arch]
    CS.FLASH_ROWS = tuple(r for r in CS.FLASH_ROWS if r[0] == variant)
    CS.emit({"phase": "kernels", "rows": CS.flash_rows(args.seed)})
    CS.moe_phases(tag, seed=args.seed, **CS.MOE_SERVE[tag])
    CS.emit({"phase": "wall", "seconds": time.perf_counter() - start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
