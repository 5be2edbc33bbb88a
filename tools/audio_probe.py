"""Run chip_smoke.py's hubert-xlarge rows and audio phases alone on one
card.

    python tools/audio_probe.py [--seed 0]

Builds the flash_attention kernels, then prints one JSON line each for
chip_smoke.py's hubert flash_attention rows (forward bf16 [1, 32768] and
fp32 [1, 1024], bidirectional, 16 heads of 80: kernel against its plain
version, bound, SDPA), its hubert flash_attention_bwd rows (bf16
[4, 4096] and fp32 [1, 1024]) and its five audio phases (audio_model,
audio_trace, audio_parity, audio_train, audio_train_parity); the card's
name and power limit first.  The quick check of a change to the head_dim
80 kernels or the audio path before a whole chip_smoke.py, which runs the
same rows and phases among the others.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("audio_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # IEEE fp32 for every fp32 product, as chip_smoke.py sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.nvidia_smi(), flush=True)
    start = time.perf_counter()
    flash_attention.build()
    CS.FLASH_ROWS = tuple(r for r in CS.FLASH_ROWS
                          if r[0].startswith("hubert"))
    CS.BWD_ROWS = tuple(r for r in CS.BWD_ROWS if r[0].startswith("hubert"))
    CS.emit({"phase": "kernels",
             "rows": CS.flash_rows(args.seed) + CS.flash_bwd_rows(args.seed)})
    CS.audio_phases(args.seed)
    CS.emit({"phase": "wall", "seconds": time.perf_counter() - start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
