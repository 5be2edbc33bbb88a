"""Public SSD-scan function: the CUDA kernels for tensors on the card, the
plain torch version (``ref.ssd_chunked``) for tensors on the CPU, and for
meta tensors (the dry run's pricing, where nothing executes).

Where autograd records the card's call (grad mode on and an input that
requires a gradient), it goes through ``SSDScan``: its forward also keeps
the fp32 state before each chunk (``scan(..., stats=True)``), and its
backward hands it to the backward kernel (``ssd_scan.scan_bwd``);
otherwise the forward kernel is called directly, with no statistics.  A
second derivative through the backward kernel raises
(``once_differentiable``) instead of reading as zero.  A tensor on the
card always goes to the kernels: if they cannot be built or launched, the
call raises; there is no fallback.  ``launches`` and ``bwd_launches`` count
the kernel launches (``bwd_path_launches`` the backward's by path);
``reset_launches`` zeroes them all.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from . import ssd_scan as _cuda
from .ref import ssd_chunked
from .ssd_scan import (  # noqa: F401
    bwd_launches, bwd_path_launches, check_chunk, launches, reset_launches,
)


class SSDScan(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bc, Cc, D, chunk):
        y, h_final, h_before = _cuda.scan(xh, dt, A, Bc, Cc, D, chunk=chunk,
                                          stats=True)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xh, dt, A, Bc, Cc, D, h_before)
        return y, h_final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_final):
        xh, dt, A, Bc, Cc, D, h_before = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xh.shape, dtype=xh.dtype, device=xh.device)
        elif not _cuda._tma_ok(dy):          # e.g. an expanded gradient
            dy = dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.float().contiguous()
        grads = _cuda.scan_bwd(xh, dt, A, Bc, Cc, D, dy, dh_final,
                               h_before, chunk=ctx.chunk)
        return (*grads, None)


def _on_card(t: torch.Tensor) -> bool:
    """True for a tensor on the card; False for one on the CPU, or on the
    meta device (the dry run, where nothing executes: the plain version
    gives the shapes and the operations to count)."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"ssd_scan runs on cuda or cpu tensors (meta ones "
                     f"through the plain version), not {t.device}")


def ssd_scan(xh, dt, A, Bc, Cc, D, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``models.ssm.ssd_chunked``.  xh [B,S,H,P]; dt [B,S,H]
    (softplus-ed); A [H] (<0); Bc/Cc [B,S,N]; D [H].  Returns (y [B,S,H,P]
    in xh's dtype, h_final [B,H,P,N] in fp32); ``S % chunk`` must be 0."""
    check_chunk(xh.shape[1], chunk)
    if _on_card(xh):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (xh, dt, A, Bc, Cc, D)):
            return SSDScan.apply(xh, dt, A, Bc, Cc, D, chunk)
        return _cuda.scan(xh, dt, A, Bc, Cc, D, chunk=chunk)
    y, h_final = ssd_chunked(xh, dt, A, Bc, Cc, D, chunk)
    return y, h_final.float()
