"""Build and launch the hand-written CUDA kernels of ``csrc/dvv_ops.cu``.

The kernels replace the Pallas TPU kernels of the JAX package's
``kernels/dvv_ops/dvv_ops.py``; the source note at the top of the ``.cu``
file says which one each replaces and what bounds it on an H100.

Build: at first use, ``kernels/build.py`` compiles every ``csrc/*.cu``
for ``sm_90a`` into ``build/repro_torch/dvv_ops-<hash>/`` and the library
is loaded once with ``ctypes``: each pointer and the stream cross as
``c_void_p``.  There is no fallback: without ``nvcc`` the build raises.

Two paths for the sweeps, chosen by ``tiled_path`` from the shape (and by
the wrapper from the arrays' alignment): ``"tiled"`` (K and R in 1..8,
every array 16-byte aligned: one thread a key, its clocks read straight
from device memory up to 16,384 keys and staged through shared memory
beyond) and ``"general"`` (every other shape: the first design, one
thread a (key, slot)).  One C function launches either, with its launch
shape (``dvv_sweep_launch``); ``path_launches`` counts calls by path.

Launch: each wrapper checks device (the current CUDA device), dtype,
shape and contiguity, allocates its outputs, launches on PyTorch's
current stream without synchronising, raises if the C entry point reports
a CUDA error, and adds one to its count in ``launches``.  ``bool`` tensors
cross as uint8 bytes.  ``stage_sweep`` is the front end's one call: copy
in, sweep and copy out through pinned memory, then wait (``ops.py``).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import build as _build

CSRC = Path(__file__).resolve().parent / "csrc"
TILED_MAX_K = TILED_MAX_R = 8   # the tiled kernels' compile-time bounds

#: Launches of each kernel since the last ``reset_launches``.
launches: Dict[str, int] = {"dvv_sync_mask": 0, "dvv_read_sweep": 0,
                            "dvv_leq": 0}
#: The sweeps' launches by path (``tiled_path``).
path_launches: Dict[str, int] = {"tiled": 0, "general": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def reset_launches() -> None:
    for counts in (launches, path_launches):
        for name in counts:
            counts[name] = 0


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash) and return the library."""
    return _build.build("dvv_ops", CSRC)


def load(path) -> ctypes.CDLL:
    """Load a library built from a ``dvv_ops.cu`` and declare its C entry
    points.  A build of the first design's source has its own:
    ``dvv_sync_mask_launch`` and ``dvv_read_sweep_launch`` (which takes the
    keys a block owns)."""
    lib = ctypes.CDLL(str(path))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {"dvv_sweep_launch": [p, p, p, p, p, p, i64, i, i, i, p],
            "dvv_sweep_staged": [p, p, i64, i64, i64, p, i64, i, i, i, p],
            "dvv_leq_launch": [p, p, p, p, p, p, p, i64, i, p],
            "dvv_sync_mask_launch": [p, p, p, p, p, i64, i, i, p],
            "dvv_read_sweep_launch": [p, p, p, p, p, p, i64, i, i, i, p]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = load(build())
    return _lib


def tiled_path(N: int, K: int, R: int) -> str:
    """``"tiled"`` where the tiled kernels take [N, K, R] (1 <= K, R <= 8),
    else ``"general"``."""
    if 1 <= K <= TILED_MAX_K and 1 <= R <= TILED_MAX_R:
        return "tiled"
    return "general"


def stream_of(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, which must
    be the current CUDA device: the kernels launch there."""
    index = device.index
    if index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is cuda:{torch.cuda.current_device()}: call "
                         f"under torch.cuda.device({device})")
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(device).cuda_stream


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
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
    dev, nk = vvs.device, (N, K)
    if not (vvs.dtype == dot_ids.dtype == dot_ns.dtype == torch.int32
            and valid.dtype == torch.bool
            and dot_ids.shape == dot_ns.shape == valid.shape == nk
            and dot_ids.device == dot_ns.device == valid.device == dev
            and vvs.is_contiguous() and dot_ids.is_contiguous()
            and dot_ns.is_contiguous() and valid.is_contiguous()):
        _check("vvs", vvs, torch.int32, (N, K, R), dev)   # names the fault
        _check("dot_ids", dot_ids, torch.int32, nk, dev)
        _check("dot_ns", dot_ns, torch.int32, nk, dev)
        _check("valid", valid, torch.bool, nk, dev)
    return N, K, R


def _sweep(name: str, vvs, dot_ids, dot_ns, valid, mask,
           ceil: Optional[torch.Tensor]) -> None:
    """Launch the sweep ``name`` into ``mask`` (and ``ceil``): the tiled
    path where ``tiled_path`` takes the shape and every array is 16-byte
    aligned, else the general path."""
    N, K, R = vvs.shape
    ptrs = [t.data_ptr() for t in (vvs, dot_ids, dot_ns, valid, mask)]
    cptr = None if ceil is None else ceil.data_ptr()
    path = tiled_path(N, K, R)
    if path == "tiled" and any(p % 16 for p in ptrs + [cptr or 0]):
        path = "general"
    err = _load().dvv_sweep_launch(*ptrs, cptr, N, K, R,
                                   int(path == "tiled"),
                                   stream_of(vvs.device))
    _raise_on(err, name)
    launches[name] += 1
    path_launches[path] += 1


def sync_mask(vvs: torch.Tensor, dot_ids: torch.Tensor, dot_ns: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Survival mask bool[N, K] of each key's clock set, on the card."""
    N, K, R = _sweep_args(vvs, dot_ids, dot_ns, valid)
    out = torch.empty((N, K), dtype=torch.bool, device=vvs.device)
    if N and K:
        _sweep("dvv_sync_mask", vvs, dot_ids, dot_ns, valid, out, None)
    return out


def read_sweep(vvs: torch.Tensor, dot_ids: torch.Tensor, dot_ns: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survival mask bool[N, K] and §5.4 ceilings int64[N, R] of the
    survivors, in one kernel on the card.  (Two allocations: on the H100's
    host one ``torch.empty`` costs less than the views that would cut two
    outputs from one buffer; ``tools/dvv_ops_probe.py``'s wrapper_host_us.)"""
    N, K, R = _sweep_args(vvs, dot_ids, dot_ns, valid)
    mask = torch.empty((N, K), dtype=torch.bool, device=vvs.device)
    ceil = torch.empty((N, R), dtype=torch.int64, device=vvs.device)
    if N == 0 or K == 0:
        return mask, ceil.zero_()
    _sweep("dvv_read_sweep", vvs, dot_ids, dot_ns, valid, mask, ceil)
    return mask, ceil


def stage_sweep(host: torch.Tensor, dev: torch.Tensor, in_bytes: int,
                out_off: int, out_bytes: int, offsets, N: int, K: int,
                R: int) -> None:
    """The front end's sweep (``ops.py``): one async copy of
    ``host[:in_bytes]`` (pinned) to ``dev``, the sweep on the arrays at
    byte ``offsets`` (vvs, ids, ns, valid, mask, ceilings or -1) of
    ``dev``, each 16-byte aligned, one async copy of ``out_bytes`` at
    ``out_off`` back into ``host``, and one wait for the stream; counts the
    launch."""
    path = tiled_path(N, K, R)
    offs = (ctypes.c_int64 * 6)(*offsets)
    err = _load().dvv_sweep_staged(
        host.data_ptr(), dev.data_ptr(), in_bytes, out_off, out_bytes,
        ctypes.cast(offs, ctypes.c_void_p), N, K, R, int(path == "tiled"),
        stream_of(dev.device))
    name = "dvv_sync_mask" if offsets[5] < 0 else "dvv_read_sweep"
    _raise_on(err, name)
    launches[name] += 1
    path_launches[path] += 1


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
    err = _load().dvv_leq_launch(
        vx.data_ptr(), ix.data_ptr(), nx.data_ptr(), vy.data_ptr(),
        iy.data_ptr(), ny.data_ptr(), out.data_ptr(), N, R,
        stream_of(vx.device))
    _raise_on(err, "dvv_leq")
    launches["dvv_leq"] += 1
    return out
