"""Run chip_smoke.py's phases of one served MoE config alone on one card.

    python tools/moe_probe.py [--arch qwen3-moe-30b-a3b | grok-1-314b |
                               jamba-1.5-large-398b] [--seed 0]

Builds the flash_attention and ssd_scan kernels, then prints one JSON
line each for
chip_smoke.py's flash_attention row at the config's prefill shape (kernel
against its plain version, bound, SDPA) and its three phases through
chip_smoke.moe_phases: qwen3-moe-30b-a3b's moe_model (bf16 parameters, a
timed prefill of [1, 4096] launching flash_attention 48 times, 8 requests
served and read back), moe_trace with the device-time breakdown by MoE
part and moe_parity; or grok-1-314b's grok_model (full width cut to 6
layers, bf16, [1, 8192], 6 launches), grok_trace and grok_parity (the
kernels against the plain versions too); or jamba-1.5-large-398b's
flash_attention and ssd_scan rows (the SSD scan at 256 heads) and its
four phases through chip_smoke.jamba_phases: jamba_model (full width cut
to pattern[:5], bf16, [1, 8192]: one flash launch and four SSD scans),
jamba_long (the long_500k decode step), jamba_trace and jamba_parity; the
card's name and power limit first.  The quick check of a change to the
MoE or hybrid path (about 100 s of command for qwen3-moe or jamba) before
a whole chip_smoke.py, which runs the same phases after the store's and
the other models'.
"""
import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    build as build_ssd,
)

#: each arch's flash row in chip_smoke.FLASH_ROWS and its phases' tag in
#: chip_smoke.MOE_SERVE (jamba: its row in chip_smoke.SSD_ROWS too, and
#: chip_smoke.jamba_phases)
ARCHS = {CS.MOE_ARCH: ("qwen3_moe", "moe"), CS.GROK_ARCH: ("grok", "grok"),
         CS.JAMBA_ARCH: ("jamba", "jamba")}


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
    with ThreadPoolExecutor(2) as pool:     # one nvcc each, together
        list(pool.map(lambda build: build(), (flash_attention.build,
                                              build_ssd)))
    variant, tag = ARCHS[args.arch]
    CS.FLASH_ROWS = tuple(r for r in CS.FLASH_ROWS if r[0] == variant)
    CS.SSD_ROWS = tuple(r for r in CS.SSD_ROWS if r[0] == variant)
    CS.emit({"phase": "kernels", "rows": CS.flash_rows(args.seed)
             + CS.ssd_rows(args.seed)})
    if tag == "jamba":
        CS.jamba_phases(args.seed)
    else:
        CS.moe_phases(tag, seed=args.seed, **CS.MOE_SERVE[tag])
    CS.emit({"phase": "wall", "seconds": time.perf_counter() - start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
