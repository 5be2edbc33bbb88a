"""The public decode-attention function: the CUDA kernel for tensors on the
card, the plain torch version (``ref.decode_attention_ref``) for tensors
on the CPU or the meta device (the dry run, where nothing executes).  A
tensor on the card always goes to the kernel: if it cannot be built or
launched, or the call's shape is not one of its instances, the call
raises; there is no fallback.

Under ``runtime.tracing.enable()`` each call adds B * (pos - lo + 1) to
the counter ``decode_attention.keys_read`` (the live keys the kernel
reads) and B * Smax to ``decode_attention.keys_cached`` (the keys the
cache holds); their ratio is the share of the cache read.  Both are host
ints: nothing is read back from the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...runtime import tracing
from . import decode_attention as _cuda
from .decode_attention import launches, reset_launches  # noqa: F401
from .ref import decode_attention_ref, live_keys


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos: int, *, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q [B,1,KV,G,D] (one query a sequence, at position ``pos``, its heads
    grouped by their KV head); k, v [B,Smax,KV,D], the cache with ``pos``
    already written -> [B,1,KV,G,D].  Keys lo..pos attend, lo = max(0,
    pos - window + 1) under a sliding window, else 0."""
    B, Smax = k.shape[0], k.shape[1]
    tracing.count("decode_attention.keys_read",
                  B * len(live_keys(pos, window)))
    tracing.count("decode_attention.keys_cached", B * Smax)
    if q.device.type == "cuda":
        return _cuda.attend(q, k, v, pos, window=window, softcap=softcap,
                            scale=scale)
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, pos, window=window,
                                    softcap=softcap, scale=scale)
    raise ValueError(f"decode_attention runs on cuda or cpu tensors (meta "
                     f"ones through the plain version), not {q.device}")
