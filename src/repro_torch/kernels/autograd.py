"""Forward-only autograd for a hand-written CUDA kernel without a backward.

The TPU kernels of the JAX package have no backward.  flash_attention has
a hand-written one (``flash_attention.ops.FlashAttention``); ssd_scan has
none yet (ROADMAP.md Queue 1 item 7.1b).  A kernel launched through
``ctypes`` writes into a ``torch.empty`` output that autograd knows
nothing of, so a loss computed through it would lose the kernel's inputs
from its graph without a word.  ``forward_only`` routes such a call through a
``torch.autograd.Function`` whenever autograd would record it, so that
``backward`` reaches the kernel and raises ``NotImplementedError`` instead.
Under ``torch.no_grad`` (prefill, serving), or when no input requires a
gradient, the kernel is called directly.
"""
from __future__ import annotations

from typing import Callable

import torch


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name: str, fn: Callable, *tensors):
        ctx.name = name
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name}: the CUDA kernel has no backward yet (ROADMAP.md "
            f"Queue 1 item 7.1b); gradients through it would be wrong, so "
            f"none are given.  CPU tensors take the plain version, which "
            f"has one.")


def forward_only(name: str, fn: Callable, *tensors: torch.Tensor):
    """``fn(*tensors)``; recorded by autograd with a backward that raises
    where any of ``tensors`` requires a gradient and grad mode is on."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ForwardOnly.apply(name, fn, *tensors)
    return fn(*tensors)
