"""Build the ssd_scan CUDA kernel and time it alone on one card.

    python tools/ssd_scan_probe.py

Prints the card (nvidia-smi: name, power limit, SM clock, power draw,
temperature) before and after, the nvcc seconds and ptxas's registers
and spills, then for
mamba2-780m's widths (48 heads of 64, state 128, chunk 256) at fp32
[1, 4096], bf16 [1, 32768] and bf16 [4, 32768]: the kernel's mean CUDA-event
milliseconds over 3 calls after one warm-up and, for batch 1, its error
(max |got - want| / max |want| for y and h_final) against the plain version
run in fp32 on the upcast inputs.  Inputs are drawn on the card: x, B, C,
D ~ N(0, 1), dt in [0.01, 0.2], A in [-2, -0.5].  A quick check of a kernel
change; chip_smoke.py is the full run.
"""
import importlib
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels.build import build_info  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan").build()
    print(build_info["ssd_scan"]["seconds"], flush=True)
    print("\n".join(ln for ln in str(build_info["ssd_scan"]["log"])
                    .splitlines()
                    if "Used" in ln or "spill" in ln or "entry" in ln),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    H, P, N, c = 48, 64, 128, 256
    for B, S, dtype in ((1, 4096, torch.float32), (1, 32768, torch.bfloat16),
                        (4, 32768, torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(B, S, H * P, device="cuda", generator=g).to(
            dtype).view(B, S, H, P)
        dt = (torch.rand(B, S, H, device="cuda", generator=g) * 0.19
              + 0.01).to(dtype)
        A = -(torch.rand(H, device="cuda", generator=g) * 1.5 + 0.5).to(dtype)
        Bc = torch.randn(B, S, N, device="cuda", generator=g).to(dtype)
        Cc = torch.randn(B, S, N, device="cuda", generator=g).to(dtype)
        D = torch.randn(H, device="cuda", generator=g).to(dtype)
        y, h = ssd_scan(x, dt, A, Bc, Cc, D, chunk=c)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            ssd_scan(x, dt, A, Bc, Cc, D, chunk=c)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 3
        ry = rh = None
        if B == 1:
            wy, wh = ssd_chunked(*(t.float() for t in (x, dt, A, Bc, Cc, D)),
                                 c)
            ry = float((y.float() - wy).abs().max() / wy.abs().max())
            rh = float((h - wh).abs().max() / wh.abs().max())
            del wy, wh
        print(B, S, dtype, "ms", ms, "rel y", ry, "rel h", rh, flush=True)
        del x, dt, Bc, Cc, y, h
        torch.cuda.empty_cache()
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
