"""Build and launch the hand-written CUDA kernels of
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

The kernel replaces the Pallas TPU kernel ``flash_attention`` of the JAX
package's ``kernels/flash_attention/flash_attention.py`` (and the KV-head
``repeat`` of its ``ops.py``); the source note at the top of the ``.cu``
file says what bounds it on an H100 and what its design does about that.
bf16 runs on Hopper's ``wgmma`` with K and V tiles brought by TMA (the
Tensor Memory Accelerator) through a ring of shared-memory stages, fed by a
producer warpgroup; fp32 runs on plain IEEE FMAs.

Build: at first use, ``kernels/build.py`` compiles ``csrc/*.cu`` for
``sm_90a`` into ``build/repro_torch/flash_attention-<hash>/`` and the
library is loaded with ``ctypes``.  There is no fallback: without ``nvcc``
the build raises.

Launch: ``attend`` checks device, dtype, shape and layout, allocates the
output with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the C entry point reports a CUDA error, and adds
one to ``launches["flash_attention"]``.  With ``positions`` it masks by
position through the kernels' second instance (``flash_attention_pos_launch``,
which also writes each tile's least and greatest position into scratch the
wrapper allocates).  The bf16 kernel reads q, k and v
through TMA tensor maps built on the host from the views' strides, so every
view (of either dtype) must follow TMA's rules: a 16-byte aligned start
and, on every axis but the last, a stride that is a multiple of 16 bytes
and, where the axis is longer than 1, not 0.

Statistics: ``attend(..., stats=True)`` (bf16; ``FlashAttention`` asks
for it when autograd records the call) also returns each row's logsumexp
of its scores (fp32 [B, H, Sq]) and the output before its rounding to bf16
(fp32 [B, Sq, H, D]), through the entry point
``flash_attention_stats_launch``; without it the kernel runs exactly as
before.

Backward: ``attend_bwd`` takes the forward's q, k, v and output (and, for
bf16, those statistics: ``lse=`` and ``out32=``, recomputed by one forward
launch when not given) and the output's gradient and returns dq, dk and
dv (source note at the top of ``flash_attention_bwd.cu``).  It allocates
the fp32 row scratch and, when the key tiles alone would leave the card's
SMs idle, fp32 partials of dk and dv that the last kernel sums
(``kv_splits``), and adds one to ``bwd_launches["flash_attention_bwd"]``.
bf16 runs on ``wgmma`` fed by TMA (q, k, v and dout must follow TMA's
rules, as in the forward), fp32 on fp32 FMAs reading views with 16-byte
copies; ``bwd_layout_fault`` says what a view lacks for either.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import build as _build

CSRC = Path(__file__).resolve().parent / "csrc"
#: The kernels' template instances.  At 80 (hubert-xlarge) the bf16
#: kernels keep their 128-column shared-memory layout (TMA zero-fills the
#: columns past 80, nothing writes them) and multiply at 80 columns; the
#: fp32 kernels hold 80 columns as they are.
HEAD_DIMS = (64, 80, 128, 256)
DTYPES = {torch.bfloat16: 1, torch.float32: 0}

#: Launches of the kernel since the last ``reset_launches``.
launches: Dict[str, int] = {"flash_attention": 0}
#: Launches of the backward since the last ``reset_launches``.
bwd_launches: Dict[str, int] = {"flash_attention_bwd": 0}
FMA_KEY_TILE = 32                # keys per block of the fp32-FMA dk/dv kernel
WGMMA_TILE = 64                  # q rows and keys per tile of the bf16 kernels

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    launches["flash_attention"] = 0
    bwd_launches["flash_attention_bwd"] = 0


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash) and return the library."""
    return _build.build("flash_attention", CSRC)


def load(path) -> ctypes.CDLL:
    """Load a library built from a ``flash_attention.cu`` and declare its C
    entry point."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, i, p, f, f, i, i, i, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    if hasattr(lib, "flash_attention_pos_launch"):
        lib.flash_attention_pos_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, p, f, f, i, i, i, p, p, p]
        lib.flash_attention_pos_launch.restype = ctypes.c_int
    if hasattr(lib, "flash_attention_stats_launch"):
        lib.flash_attention_stats_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, p, f, f, i, i, p, p, p, p, p]
        lib.flash_attention_stats_launch.restype = ctypes.c_int
    if hasattr(lib, "flash_attention_grad_launch"):
        lib.flash_attention_grad_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, f, f, i, i, i,
            p, p, p, p, i, p]
        lib.flash_attention_grad_launch.restype = ctypes.c_int
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def _check_layout(name: str, t: torch.Tensor, dtype: torch.dtype,
                  device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension")
    vec = 16 // t.element_size()            # TMA: 16-byte address, strides
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned with strides that "
                         f"are multiples of {vec} elements")
    if any(s == 0 and n > 1 for s, n in zip(t.stride()[:3], t.shape[:3])):
        raise ValueError(f"{name} broadcasts an axis (stride 0): TMA maps "
                         f"take positive strides")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, softcap: float = 0.0,
           scale: Optional[float] = None,
           positions: Optional[torch.Tensor] = None,
           stats: bool = False, lib: Optional[ctypes.CDLL] = None):
    """Flash attention on the card.  q [B,Sq,H,D]; k, v [B,Sk,KV,D] with
    H % KV == 0 (strides as ``_check_layout`` takes them, D contiguous) ->
    [B,Sq,H,D] in q's dtype.  Query head h reads KV head h // (H // KV).
    Positions count from 0 on both sides, or are ``positions`` (int32 [S],
    contiguous, on q's device; Sq == Sk == S), one vector for queries and
    keys.  ``stats`` (bf16 only) returns (out, lse, out32) instead: each
    row's logsumexp of its scores, fp32 [B,H,Sq], and the output before
    its rounding, fp32 [B,Sq,H,D] (``ref.flash_attention_stats_ref``), for
    ``attend_bwd``.  ``lib`` is another build of the kernel (from
    ``load``) to launch instead of the package's, for comparing designs."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {list(DTYPES)}, "
                        f"got {q.dtype}")
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k must be [{B}, Sk, KV, {D}], got "
                         f"{tuple(k.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v has shape {tuple(v.shape)}, expected "
                         f"{tuple(k.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t, q.dtype, q.device)
    if positions is not None:
        if positions.device != q.device or positions.dtype != torch.int32 \
                or tuple(positions.shape) != (Sq,) or Sk != Sq \
                or not positions.is_contiguous():
            raise ValueError(f"positions must be contiguous int32 [{Sq}] "
                             f"on {q.device} with Sk == Sq, got "
                             f"{positions.dtype} {tuple(positions.shape)} "
                             f"on {positions.device} (Sk {Sk})")
    if stats and q.dtype != torch.bfloat16:
        raise TypeError("attend(stats=True) takes bf16: the fp32 backward "
                        "computes its own statistics")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if stats:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out32 = torch.empty((B, Sq, H, D), dtype=torch.float32,
                            device=q.device)
    if out.numel() == 0 or Sk == 0:
        out.zero_()
        return (out, lse.fill_(-float("inf")), out32.zero_()) if stats \
            else out
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    lib = _load() if lib is None else lib
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, D, ctypes.cast(strides, ctypes.c_void_p),
            float(scale or D ** -0.5), float(softcap), int(bool(causal)),
            int(window))
    # with positions: each key tile's and 64-row q group's least and
    # greatest position (key tiles of 32 keys or more)
    bounds = None if positions is None else torch.empty(
        2 * (-(-Sk // 32) + -(-Sq // 64)), dtype=torch.int32,
        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if stats:
            err = lib.flash_attention_stats_launch(
                *args, positions.data_ptr() if bounds is not None else None,
                bounds.data_ptr() if bounds is not None else None,
                lse.data_ptr(), out32.data_ptr(), stream)
        elif positions is None:
            err = lib.flash_attention_launch(*args, DTYPES[q.dtype], stream)
        else:
            err = lib.flash_attention_pos_launch(
                *args, DTYPES[q.dtype], positions.data_ptr(),
                bounds.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA "
                           f"error {err}")
    launches["flash_attention"] += 1
    return (out, lse, out32) if stats else out


def bwd_layout_fault(t: torch.Tensor) -> Optional[str]:
    """What keeps the backward from reading the view ``t`` (bf16: TMA
    tensor maps; fp32: 16-byte copies), or None.  A stride on an axis of
    length 1 never counts: autograd hands a [1, S, H, D] gradient a batch
    stride of 1, and the tensor map is given a valid one instead."""
    if t.stride(-1) != 1:
        return "must have a contiguous last dimension"
    vec = 16 // t.element_size()
    long = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    if t.data_ptr() % 16 or any(st % vec for st in long):
        return (f"must be 16-byte aligned with strides that are multiples "
                f"of {vec} elements")
    if 0 in long:
        return "broadcasts an axis (stride 0): TMA maps take positive strides"
    return None


def bwd_key_tile(dtype: torch.dtype) -> int:
    """Keys per block of the dk/dv kernel at every head_dim: 64 for bf16
    (``wgmma``), the FMAs' 32 for fp32."""
    return WGMMA_TILE if dtype == torch.bfloat16 else FMA_KEY_TILE


def kv_splits(B: int, KV: int, Sk: int, G: int, sms: int,
              key_tile: int) -> int:
    """How many blocks share each (b, KV head, key tile) of the dk/dv
    kernel, each taking G / splits of its query heads: the least divisor
    of G that gives at least two blocks per SM, or G."""
    tiles = B * KV * -(-Sk // key_tile)
    for n in range(1, G + 1):
        if G % n == 0 and tiles * n >= 2 * sms:
            return n
    return G


def attend_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, *,
               causal: bool = True, window: int = 0, softcap: float = 0.0,
               scale: Optional[float] = None,
               positions: Optional[torch.Tensor] = None,
               lse: Optional[torch.Tensor] = None,
               out32: Optional[torch.Tensor] = None,
               lib: Optional[ctypes.CDLL] = None):
    """The gradient of ``attend`` on the card: q, out, dout [B,Sq,H,D];
    k, v [B,Sk,KV,D] (all of q's dtype and device, each a view that
    ``bwd_layout_fault`` passes) -> (dq, dk, dv) in the inputs' shapes and
    dtype.  bf16 reads the forward's statistics ``lse`` and ``out32``
    (``attend(..., stats=True)``); when either is None one forward launch
    recomputes both, which gives the same bits; it does not read ``out``,
    so ``out``'s layout is not checked.  fp32 reads ``out`` and no
    statistics.  The other arguments are ``attend``'s; ``lib`` is
    another build of both kernels (from ``load``)."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {q.device}")
    if q.dim() != 4 or q.dtype not in DTYPES:
        raise ValueError(f"q must be a [B, S, H, D] tensor of "
                         f"{list(DTYPES)}, got {q.dtype} {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [{B}, Sk, KV, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape)):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    bf16 = q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{q.dtype} on {q.device}")
        fault = None if bf16 and name == "out" else bwd_layout_fault(t)
        if fault:
            raise ValueError(f"{name} {fault}")
    if positions is not None:
        if positions.device != q.device or positions.dtype != torch.int32 \
                or tuple(positions.shape) != (Sq,) or Sk != Sq \
                or not positions.is_contiguous():
            raise ValueError(f"positions must be contiguous int32 [{Sq}] "
                             f"on {q.device} with Sk == Sq, got "
                             f"{positions.dtype} {tuple(positions.shape)} "
                             f"on {positions.device} (Sk {Sk})")
    for name, t, shape in (("lse", lse, (B, H, Sq)),
                           ("out32", out32, (B, Sq, H, D))):
        if t is not None and (t.device != q.device
                              or t.dtype != torch.float32
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if Sq == 0 or Sk == 0 or B == 0 or H == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _load() if lib is None else lib
    if bf16 and (lse is None or out32 is None):
        _, lse, out32 = attend(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               positions=positions, stats=True, lib=lib)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = kv_splits(B, KV, Sk, H // KV, sms, bwd_key_tile(q.dtype))
    # bf16: delta [B,H,Sq]; fp32: m, l and delta
    stats = torch.empty((1 if bf16 else 3) * B * H * Sq,
                        dtype=torch.float32, device=q.device)
    partials = torch.empty(2 * nsplit * B * Sk * KV * D if nsplit > 1
                           else 0, dtype=torch.float32, device=q.device)
    # with positions, each tile's least and greatest position: bf16 over
    # 64-row chunks and dq's key tiles of 48 or 64 (Sq == Sk), fp32 over
    # its 32-key and 64-row tiles
    n_bounds = 0 if positions is None else \
        2 * (-(-Sk // WGMMA_TILE) + -(-Sk // 48)) if bf16 else \
        2 * (-(-Sk // FMA_KEY_TILE) + -(-Sq // 64))
    bounds = torch.empty(n_bounds, dtype=torch.int32, device=q.device)
    views = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_int64 * 24)(*(s for t in views
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_grad_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bf16 else out.data_ptr(),
            out32.data_ptr() if bf16 else None,
            lse.data_ptr() if bf16 else None, dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, KV, Sq, Sk, D, ctypes.cast(strides, ctypes.c_void_p),
            float(scale or D ** -0.5), float(softcap), int(bool(causal)),
            int(window), DTYPES[q.dtype],
            positions.data_ptr() if positions is not None else None,
            bounds.data_ptr(), stats.data_ptr(), partials.data_ptr(),
            nsplit, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed with "
                           f"CUDA error {err}")
    bwd_launches["flash_attention_bwd"] += 1
    return dq, dk, dv
