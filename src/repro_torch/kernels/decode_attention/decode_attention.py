"""Build and launch the hand-written CUDA kernel of
``csrc/decode_attention.cu``: one decode step's attention over the live
keys of a KV cache, split over the keys.

The kernel replaces no TPU kernel: the JAX package's decode attention is
jnp (``src/repro/models/attention.py:192``).  The source note at the top of
the ``.cu`` file says what bounds it on an H100 (bytes) and what its design
does about that.

Build: at first use, ``kernels/build.py`` compiles ``csrc/*.cu`` for
``sm_90a`` into ``build/repro_torch/decode_attention-<hash>/`` (a library of
its own: the flash kernels' templates are not built for it) and the
library is loaded with ``ctypes``.  There is no fallback: without ``nvcc``
the build raises.

Launch: ``attend`` checks device, dtype, shape, layout and ``pos``,
allocates the output and, with more than one split, the fp32 scratch of
the splits' partials with ``torch.empty``, launches on PyTorch's current
stream without synchronising, raises if the C entry point reports a CUDA
error, and adds one to ``launches["decode_attention"]`` (and to
``launches["decode_attention_combine"]`` when the splits' partials are
summed by the second kernel).  ``pos`` and the window are host ints passed
as kernel arguments: nothing is copied between host and device.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import build as _build
from .ref import live_keys

CSRC = Path(__file__).resolve().parent / "csrc"
#: Head widths of the kernel's instances: 128 and 256 (gemma), those of the
#: decoders of ``configs/`` at full width, and 16 (every ``.smoke()``
#: config).  Any other width raises on a CUDA tensor.
HEAD_DIMS = (16, 128, 256)
#: Query heads a KV head (G = H // KV), at most.
MAX_GROUP = 8
DTYPES = {torch.bfloat16: 1, torch.float32: 0}
#: Blocks a split-KV launch aims at, per SM (4 warps each).
BLOCKS_PER_SM = 4
#: Keys a split reads, at least.
MIN_SPLIT_KEYS = 256

#: Launches since the last ``reset_launches``: the kernel, and the second
#: kernel that sums the splits' partials.
launches: Dict[str, int] = {"decode_attention": 0,
                            "decode_attention_combine": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_sms: Dict[int, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash) and return the library."""
    return _build.build("decode_attention", CSRC)


def _load() -> ctypes.CDLL:
    """The built library, loaded once, its C entry point declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.decode_attention_launch.argtypes = [
                p, p, p, p, p, i, i, i, i, p, i, i, i, i, f, f, i, p]
            lib.decode_attention_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def splits(B: int, KV: int, L: int, sms: int) -> Tuple[int, int]:
    """(nsplit, chunk): the live keys cut into nsplit chunks of ``chunk``
    keys (the last may be shorter, none is empty).  B * KV blocks a split;
    splits are added until the launch has about BLOCKS_PER_SM blocks an
    SM, as long as each split keeps MIN_SPLIT_KEYS keys."""
    want = -(-BLOCKS_PER_SM * sms // (B * KV))
    n = max(1, min(want, L // MIN_SPLIT_KEYS))
    chunk = -(-L // n)
    return -(-L // chunk), chunk


def _check_view(name: str, t: torch.Tensor, dtype: torch.dtype,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension")
    vec = 16 // t.element_size()            # 16-byte loads of a row
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
        raise ValueError(f"{name} must be 16-byte aligned with strides that "
                         f"are multiples of {vec} elements")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, *,
           window: int = 0, softcap: float = 0.0,
           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention on the card.  q [B,1,KV,G,D]; k, v [B,Smax,KV,D]
    (views of q's dtype and device with D contiguous) -> [B,1,KV,G,D] in
    q's dtype, contiguous.  Keys ``ref.live_keys(pos, window)`` only;
    ``0 <= pos < Smax``."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {q.device}")
    if q.dim() != 5 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, KV, G, D], got {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes {list(DTYPES)}, "
                        f"got {q.dtype}")
    B, _, KV, G, D = q.shape
    if k.dim() != 4 or (k.shape[0], k.shape[2], k.shape[3]) != (B, KV, D) \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [{B}, Smax, {KV}, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Smax = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if not 0 < G <= MAX_GROUP:
        raise ValueError(f"decode_attention takes 1 to {MAX_GROUP} query "
                         f"heads a KV head, got {G}")
    if not 0 <= pos < Smax:
        raise ValueError(f"pos {pos} is outside the cache's {Smax} slots")
    if B > 65535 or KV > 65535:
        raise ValueError(f"B {B} and KV {KV} must be at most 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q.dtype, q.device)
    out = torch.empty((B, 1, KV, G, D), dtype=q.dtype, device=q.device)
    if B == 0 or KV == 0:
        return out
    keys = live_keys(pos, window)
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    nsplit, chunk = splits(B, KV, len(keys), _sms[dev])
    # the splits' partials: sums [B*KV*G, nsplit, D], then (max, sum)
    scratch = torch.empty(B * KV * G * nsplit * (D + 2), dtype=torch.float32,
                          device=q.device) if nsplit > 1 else None
    strides = (ctypes.c_int64 * 9)(q.stride(0), *q.stride()[2:4],
                                   *k.stride()[:3], *v.stride()[:3])
    lib = _load()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, KV, G, D,
            ctypes.cast(strides, ctypes.c_void_p), keys.start, len(keys),
            chunk, nsplit, float(scale or D ** -0.5), float(softcap),
            DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed with CUDA "
                           f"error {err}")
    launches["decode_attention"] += 1
    if nsplit > 1:
        launches["decode_attention_combine"] += 1
    return out
