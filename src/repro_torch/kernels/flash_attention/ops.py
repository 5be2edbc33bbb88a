"""Public flash-attention functions: the CUDA kernel for tensors on the
card, the plain torch version (``ref.flash_attention_ref``) for tensors on
the CPU.

The card's call goes through ``kernels.autograd.forward_only``: the kernel
has no backward yet, so a gradient through it raises instead of being
dropped. A tensor on the card always goes to the kernel: if it cannot be
built or launched, the call raises; there is no fallback. ``launches``
counts the kernel launches; ``reset_launches`` zeroes it.

``block_q`` and ``block_k`` are accepted for the JAX package's signature:
they shape the TPU kernel's grid and change nothing here (the CUDA kernel
has its own tile sizes, and neither changes the result).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..autograd import forward_only
from . import flash_attention as _cuda
from .flash_attention import launches, reset_launches
from .ref import flash_attention_ref


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                     f"not {t.device}")


def gqa_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None,
                        block_q: int = 512, block_k: int = 512,
                        positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q [B,S,H,Dh]; k, v [B,S,KV,Dh] -> [B,S,H,Dh].  The kernel reads KV
    head h // (H // KV) for query head h; nothing is repeated in memory.

    ``positions`` (int32 [S], one vector for queries and keys) masks by
    position, as the JAX package's default path masks by the temporal row
    of batch row 0; ``None`` masks by index (positions 0..S-1), as its
    Pallas path does."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              positions=positions)
    if _on_card(q):
        return forward_only("flash_attention",
                            lambda *qkv: _cuda.attend(*qkv, **kw), q, k, v)
    return flash_attention_ref(q, k, v, **kw)

