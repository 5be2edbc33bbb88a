"""Build and launch the hand-written CUDA kernel of ``csrc/ssd_scan.cu``.

The kernel replaces the Pallas TPU kernel ``ssd_scan_pallas`` of the JAX
package's ``kernels/ssd_scan/ssd_scan.py`` (with its wrapper's transpose of
x and broadcast of B and C over heads); the source note at the top of the
``.cu`` file says what bounds it on an H100 and what its design does about
that.

Build: at first use, ``kernels/build.py`` compiles ``csrc/*.cu`` for
``sm_90a`` into ``build/repro_torch/ssd_scan-<hash>/`` and the library is
loaded with ``ctypes``.  There is no fallback: without ``nvcc`` the build
raises.

Launch: ``scan`` checks device, dtype, shape and layout, allocates ``y``
and ``h_final`` with ``torch.empty``, launches on PyTorch's current stream
without synchronising, raises if the C entry point reports a CUDA error,
and adds one to ``launches["ssd_scan"]``.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import build as _build

CSRC = Path(__file__).resolve().parent / "csrc"
DTYPES = {torch.bfloat16: 1, torch.float32: 0}
MAX_P, MAX_N, TILE, MAX_CHUNK = 64, 128, 64, 1024

#: Launches of the kernel since the last ``reset_launches``.
launches: Dict[str, int] = {"ssd_scan": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash) and return the library."""
    return _build.build("ssd_scan", CSRC)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ssd_scan_launch.argtypes = [
                p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, i, i, i, p]
            lib.ssd_scan_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_chunk(S: int, chunk: int) -> None:
    """``S % chunk != 0`` raises ``ValueError`` on both devices (the JAX
    package asserts)."""
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")


def scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor, *,
         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan on the card.  xh [B,S,H,P]; dt [B,S,H]; Bc, Cc [B,S,N]
    (xh, dt, Bc and Cc in one dtype, bf16 or fp32, any strides with the last
    axis of xh, Bc and Cc contiguous); A, D [H] in bf16 or fp32.  Returns
    y [B,S,H,P] in xh's dtype and h_final [B,H,P,N] in fp32."""
    if xh.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {xh.device}")
    if xh.dim() != 4:
        raise ValueError(f"xh must be [B, S, H, P], got {tuple(xh.shape)}")
    if xh.dtype not in DTYPES:
        raise TypeError(f"ssd_scan takes {list(DTYPES)}, got {xh.dtype}")
    B, S, H, P = xh.shape
    want = {"dt": (dt, (B, S, H), xh.dtype), "A": (A, (H,), None),
            "D": (D, (H,), None)}
    if Bc.dim() != 3:
        raise ValueError(f"Bc must be [B, S, N], got {tuple(Bc.shape)}")
    N = Bc.shape[2]
    want.update(Bc=(Bc, (B, S, N), xh.dtype), Cc=(Cc, (B, S, N), xh.dtype))
    for name, (t, shape, dtype) in want.items():
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xh.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype not in DTYPES or (dtype is not None and t.dtype != dtype):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{dtype or list(DTYPES)}")
    for name, t in (("xh", xh), ("Bc", Bc), ("Cc", Cc)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    check_chunk(S, chunk)
    if not (0 < P <= MAX_P and P % 4 == 0 and 0 < N <= MAX_N
            and N % 4 == 0):
        raise ValueError(f"ssd_scan takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"both multiples of 4; got P {P}, N {N}")
    if chunk % 4 or chunk > MAX_CHUNK or (chunk > TILE and chunk % TILE):
        raise ValueError(f"ssd_scan takes a chunk that is a multiple of 4, "
                         f"at most {TILE} or a multiple of {TILE} up to "
                         f"{MAX_CHUNK}; got {chunk}")
    y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32,
                          device=xh.device)
    if B * H == 0:
        return y, h_final
    A, D = A.contiguous(), D.contiguous()
    strides = (ctypes.c_int64 * 13)(*xh.stride()[:3], *dt.stride(),
                                    *Bc.stride()[:2], *Cc.stride()[:2],
                                    *y.stride()[:3])
    lib = _load()
    with torch.cuda.device(xh.device):
        err = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            B, S, H, P, N, chunk, ctypes.cast(strides, ctypes.c_void_p),
            DTYPES[xh.dtype], DTYPES[A.dtype], DTYPES[D.dtype],
            torch.cuda.current_stream(xh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed with CUDA error {err}")
    launches["ssd_scan"] += 1
    return y, h_final
