"""Run chip_smoke.py's qwen3-moe-30b-a3b phases alone on one card.

    python tools/moe_probe.py [--seed 0]

Builds the flash_attention kernel, then prints one JSON line each for
chip_smoke.py's qwen3-moe flash_attention row (kernel against its plain
version, bound, SDPA), its moe_model phase (bf16 parameters, a timed
prefill of [1, 4096] launching flash_attention 48 times, 8 requests served
and read back), its moe_trace phase with the device-time breakdown by MoE
part, and its moe_parity phase; the card's name and power limit first.
The quick check of a change to the MoE path (about 100 s of command)
before a whole chip_smoke.py, which runs the same phases after the
store's and the other models'.
"""
import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import count_params, init_params  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    CS.FLASH_ROWS = tuple(r for r in CS.FLASH_ROWS if r[0] == "qwen3_moe")
    CS.emit({"phase": "kernels", "rows": CS.flash_rows(args.seed)})

    cfg = replace(get_config(CS.MOE_ARCH), param_dtype=CS.MOE_PARAM_DTYPE)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t = time.perf_counter()
    params = init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    moe = CS.model_phase(cfg, params, args.seed, phase="moe_model",
                         tokens=CS.MOE_PREFILL)
    moe.update(param_count=count_params(cfg), init_s=init_s)
    CS.emit(moe)
    trace = CS.model_trace_phase(cfg, params, args.seed, phase="moe_trace",
                                 tokens=CS.MOE_PREFILL)
    trace["breakdown"] = CS.moe_prefill_breakdown(cfg, params,
                                                  CS.MOE_PREFILL)
    CS.emit(trace)
    del params
    torch.cuda.empty_cache()
    CS.emit(CS.moe_parity_phase(args.seed))
    CS.emit({"phase": "wall", "seconds": time.perf_counter() - start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
