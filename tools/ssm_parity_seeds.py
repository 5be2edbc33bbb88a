"""Read mamba2-780m's gradient parity on one card, on several seeds.

    python tools/ssm_parity_seeds.py [--seeds 0 1 2 3 4]

Prints the card (nvidia-smi: name, power limit), then one JSON line per
seed: chip_smoke.py's ``ssm_grad_parity`` (2 layers at full width, fp32,
tokens [1, 1024]: the loss and every gradient leaf through the ssd_scan
kernels against the plain version, the worst leaves, and each layer's
A_log and dt_bias leaves from the kernels and from the plain version in
fp32, each against the plain version in float64 on the same inputs and
dy).  It reads and does not gate: chip_smoke.py's ssm_train_parity holds
one seed to its bounds.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_parity_seeds: no CUDA device", file=sys.stderr)
        return 2
    print(CS.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(CS.ssm_grad_parity(seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
