"""Public SSD-scan function: the CUDA kernel for tensors on the card, the
plain torch version (``ref.ssd_chunked``) for tensors on the CPU.

The card's call goes through ``kernels.autograd.forward_only``: the kernel
has no backward yet, so a gradient through it raises instead of being
dropped. A tensor on the card always goes to the kernel: if it cannot be
built or launched, the call raises; there is no fallback. ``launches``
counts the kernel launches; ``reset_launches`` zeroes it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..autograd import forward_only
from . import ssd_scan as _cuda
from .ref import ssd_chunked
from .ssd_scan import check_chunk, launches, reset_launches  # noqa: F401


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                     f"{t.device}")


def ssd_scan(xh, dt, A, Bc, Cc, D, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``models.ssm.ssd_chunked`` (forward).  xh [B,S,H,P]; dt
    [B,S,H] (softplus-ed); A [H] (<0); Bc/Cc [B,S,N]; D [H].  Returns
    (y [B,S,H,P] in xh's dtype, h_final [B,H,P,N] in fp32); ``S % chunk``
    must be 0."""
    check_chunk(xh.shape[1], chunk)
    if _on_card(xh):
        return forward_only(
            "ssd_scan", lambda *a: _cuda.scan(*a, chunk=chunk),
            xh, dt, A, Bc, Cc, D)
    y, h_final = ssd_chunked(xh, dt, A, Bc, Cc, D, chunk)
    return y, h_final.float()
