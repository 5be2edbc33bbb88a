"""Public flash-attention functions: the CUDA kernels for tensors on the
card, the plain torch version (``ref.flash_attention_ref``) for tensors on
the CPU.

Where autograd records the card's call (grad mode on and an input that
requires a gradient), it goes through ``FlashAttention``: its bf16 forward
also keeps each row's logsumexp and the fp32 output (``attend(...,
stats=True)``), and its backward hands them to the backward kernel
(``flash_attention.attend_bwd``); otherwise the forward kernel is called
directly, with no statistics. A second derivative through the
backward kernel raises (``once_differentiable``) instead of reading as
zero. A tensor on the card always goes to the kernels: if they cannot be
built or launched, the call raises; there is no fallback. ``launches``
and ``bwd_launches`` count the kernel launches, ``instance_launches`` and
``bwd_instance_launches`` the same launches by mask instance ("index" or
"positions"); ``reset_launches`` zeroes them all.

``block_q`` and ``block_k`` are accepted for the JAX package's signature:
they shape the TPU kernel's grid and change nothing here (the CUDA kernel
has its own tile sizes, and neither changes the result).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import flash_attention as _cuda
from .flash_attention import (  # noqa: F401  (re-exported)
    bwd_instance_launches, bwd_launches, instance_launches, launches,
    reset_launches,
)
from .ref import flash_attention_ref


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; the
    keyword arguments ride along in ``kw``."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        lse = out32 = None
        if q.dtype == torch.bfloat16:        # the backward's statistics
            out, lse, out32 = _cuda.attend(q, k, v, stats=True, **kw)
        else:
            out = _cuda.attend(q, k, v, **kw)
        positions = kw["positions"]
        ctx.kw = {n: w for n, w in kw.items() if n != "positions"}
        ctx.save_for_backward(q, k, v, out, positions, lse, out32)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, positions, lse, out32 = ctx.saved_tensors
        if _cuda.bwd_layout_fault(dout):     # e.g. an expanded or offset view
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _cuda.attend_bwd(q, k, v, out, dout,
                                      positions=positions, lse=lse,
                                      out32=out32, **ctx.kw)
        return dq, dk, dv, None


def _on_card(t: torch.Tensor) -> bool:
    """True for a tensor on the card; False for one on the CPU, or on the
    meta device (the dry run, where nothing executes: the plain version
    gives the shapes and the operations to count)."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"flash_attention runs on cuda or cpu tensors (meta ones "
                     f"through the plain version), not {t.device}")


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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, kw)
        return _cuda.attend(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)

