"""Run chip_smoke.py's decode_attention rows alone on one card.

    python tools/decode_attention_probe.py [--seed 0]

Builds the decode_attention kernel and prints, one JSON line each: the
card's name and power limit with ptxas's registers, shared memory and
spills for every instance; then chip_smoke.py's decode_attention rows
(grok-1's decode shape at positions 600 and 8,191, jamba's long_500k step:
kernel against its plain version, device ms, the bytes bound,
scaled_dot_product_attention beside it).  The quick check of a change to
the kernel before a whole chip_smoke.py, which runs the same rows among
the others.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.build import build_info  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    decode_attention.build()
    info = build_info["decode_attention"]
    print(json.dumps({"nvidia_smi": CS.nvidia_smi(),
                      "nvcc_seconds": info["seconds"],
                      "ptxas": CS.ptxas_lines(str(info["log"]))}),
          flush=True)
    for row in CS.decode_attention_rows(args.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
