"""Build and launch the hand-written CUDA kernels of ``csrc/dvv_ops.cu``.

The kernels replace the Pallas TPU kernels of the JAX package's
``kernels/dvv_ops/dvv_ops.py``; the source note at the top of the ``.cu``
file says which one each replaces and what bounds it on an H100.

Build: at first use, ``kernels/build.py`` compiles every ``csrc/*.cu``
for ``sm_90a`` into ``build/repro_torch/dvv_ops-<hash>/`` and the library
is loaded with ``ctypes``: each pointer and the stream cross as
``c_void_p``.  There is no fallback: without ``nvcc`` the build raises.

Launch: each wrapper checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty``, launches on PyTorch's current stream
without synchronising, raises if the C entry point reports a CUDA error,
and adds one to its count in ``launches``.  ``bool`` tensors cross as
uint8 bytes.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import build as _build

CSRC = Path(__file__).resolve().parent / "csrc"
THREADS = 256              # kThreads in the .cu source
MAX_SHARED = 48 * 1024     # static-launch shared-memory limit per block

#: Launches of each kernel since the last ``reset_launches``.
launches: Dict[str, int] = {"dvv_sync_mask": 0, "dvv_read_sweep": 0,
                            "dvv_leq": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash) and return the library."""
    return _build.build("dvv_ops", CSRC)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.dvv_sync_mask_launch.argtypes = [p, p, p, p, p, i64, i, i, p]
            lib.dvv_read_sweep_launch.argtypes = [p, p, p, p, p, p, i64, i,
                                                  i, i, p]
            lib.dvv_leq_launch.argtypes = [p, p, p, p, p, p, p, i64, i, p]
            for fn in (lib.dvv_sync_mask_launch, lib.dvv_read_sweep_launch,
                       lib.dvv_leq_launch):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _sweep_args(vvs, dot_ids, dot_ns, valid):
    if vvs.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {vvs.device}")
    if vvs.dim() != 3:
        raise ValueError(f"vvs must be [N, K, R], got {tuple(vvs.shape)}")
    N, K, R = vvs.shape
    _check("vvs", vvs, torch.int32, (N, K, R), vvs.device)
    _check("dot_ids", dot_ids, torch.int32, (N, K), vvs.device)
    _check("dot_ns", dot_ns, torch.int32, (N, K), vvs.device)
    _check("valid", valid, torch.bool, (N, K), vvs.device)
    return N, K, R


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sync_mask(vvs: torch.Tensor, dot_ids: torch.Tensor, dot_ns: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Survival mask bool[N, K] of each key's clock set, on the card."""
    N, K, R = _sweep_args(vvs, dot_ids, dot_ns, valid)
    out = torch.empty((N, K), dtype=torch.bool, device=vvs.device)
    if N == 0 or K == 0:
        return out
    lib = _load()
    with torch.cuda.device(vvs.device):
        err = lib.dvv_sync_mask_launch(
            vvs.data_ptr(), dot_ids.data_ptr(), dot_ns.data_ptr(),
            valid.data_ptr(), out.data_ptr(), N, K, R, _stream(vvs.device))
    _raise_on(err, "dvv_sync_mask")
    launches["dvv_sync_mask"] += 1
    return out


def read_sweep(vvs: torch.Tensor, dot_ids: torch.Tensor, dot_ns: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survival mask bool[N, K] and §5.4 ceilings int64[N, R] of the
    survivors, in one kernel on the card."""
    N, K, R = _sweep_args(vvs, dot_ids, dot_ns, valid)
    mask = torch.empty((N, K), dtype=torch.bool, device=vvs.device)
    ceil = torch.empty((N, R), dtype=torch.int64, device=vvs.device)
    if N == 0 or K == 0:
        return mask, ceil.zero_()
    if K > MAX_SHARED:
        raise ValueError(f"dvv_read_sweep takes K <= {MAX_SHARED}, got {K}")
    kpb = max(1, min(THREADS // max(K, R, 1), MAX_SHARED // K))
    lib = _load()
    with torch.cuda.device(vvs.device):
        err = lib.dvv_read_sweep_launch(
            vvs.data_ptr(), dot_ids.data_ptr(), dot_ns.data_ptr(),
            valid.data_ptr(), mask.data_ptr(), ceil.data_ptr(), N, K, R, kpb,
            _stream(vvs.device))
    _raise_on(err, "dvv_read_sweep")
    launches["dvv_read_sweep"] += 1
    return mask, ceil


def leq(vx: torch.Tensor, ix: torch.Tensor, nx: torch.Tensor,
        vy: torch.Tensor, iy: torch.Tensor, ny: torch.Tensor) -> torch.Tensor:
    """history(x_n) ⊆ history(y_n) for N flat pairs: bool[N], on the card."""
    if vx.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {vx.device}")
    if vx.dim() != 2:
        raise ValueError(f"vx must be [N, R], got {tuple(vx.shape)}")
    N, R = vx.shape
    for name, t, shape in (("vx", vx, (N, R)), ("vy", vy, (N, R)),
                           ("ix", ix, (N,)), ("nx", nx, (N,)),
                           ("iy", iy, (N,)), ("ny", ny, (N,))):
        _check(name, t, torch.int32, shape, vx.device)
    out = torch.empty(N, dtype=torch.bool, device=vx.device)
    if N == 0:
        return out
    lib = _load()
    with torch.cuda.device(vx.device):
        err = lib.dvv_leq_launch(
            vx.data_ptr(), ix.data_ptr(), nx.data_ptr(), vy.data_ptr(),
            iy.data_ptr(), ny.data_ptr(), out.data_ptr(), N, R,
            _stream(vx.device))
    _raise_on(err, "dvv_leq")
    launches["dvv_leq"] += 1
    return out
