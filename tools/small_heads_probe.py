"""Run chip_smoke.py's head_dim-16 and -32 flash rows, its smoke_configs
phase and its examples phase alone on one card.

    python tools/small_heads_probe.py [--seed 0] [--phases rows smoke examples]

Builds the three kernel packages (one nvcc each, together), then prints
one JSON line each for chip_smoke.py's flash_attention and
flash_attention_bwd rows at head_dim 16 and 32 (the examples' own shapes,
and [4, 4096] with 8 heads of 32 or 4 heads of 16 on 2 KV heads,
bidirectional and causal, bf16 and fp32: kernel against its plain
version, bound, SDPA), its smoke_configs phase (every registry config's
.smoke() on the card against the CPU run) and its examples phase (the
nine examples_torch scripts on the card); the card's name and power limit
first.  The quick check of a change to the small head_dims or to those
phases before a whole chip_smoke.py, which runs the same rows and phases
among the others.
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
from repro_torch.kernels.dvv_ops import dvv_ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import build as build_ssd  # noqa: E402,E501

PHASES = ("rows", "smoke", "examples")
SMALL = ("quickstart", "train_e2e", "smoke_fp32", "d16_", "d32_")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="+", choices=PHASES,
                    default=list(PHASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("small_heads_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    # IEEE fp32 for every fp32 product, as chip_smoke.py sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.nvidia_smi(), flush=True)
    start = time.perf_counter()
    builds = (dvv_ops.build, flash_attention.build, build_ssd)
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))
    if "rows" in args.phases:
        CS.FLASH_ROWS = tuple(r for r in CS.FLASH_ROWS
                              if r[0].startswith(SMALL))
        CS.BWD_ROWS = tuple(r for r in CS.BWD_ROWS if r[0].startswith(SMALL))
        CS.emit({"phase": "kernels", "rows": CS.flash_rows(args.seed) +
                 CS.flash_bwd_rows(args.seed)})
    if "smoke" in args.phases:
        CS.emit(CS.smoke_configs_phase(args.seed))
    if "examples" in args.phases:
        CS.emit(CS.examples_phase())
    CS.emit({"phase": "wall", "seconds": time.perf_counter() - start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
