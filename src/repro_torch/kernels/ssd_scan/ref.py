"""Plain torch version of the SSD kernel: the port of the JAX package's
``models.ssm.ssd_chunked`` (which its ``kernels/ssd_scan/ref.py``
re-exports as the kernel's oracle).  ``models/ssm.py`` re-exports it as
``ssd_chunked``; it lives here so that ``models/ssm.py`` can import the
kernel's front end without an import cycle.

It computes in the inputs' dtype, as the JAX function does: bf16 inputs
give bf16 intermediates and a bf16 state.  ``lax.scan`` over the chunks
becomes a Python loop.  ``ops`` runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh [B,S,H,P] (P=headdim), dt [B,S,H] (softplus-ed), A [H] (negative),
    Bc/Cc [B,S,N], D [H].  Returns (y [B,S,H,P], final state [B,H,P,N]).
    """
    B_, S, H, P = xh.shape
    N = Bc.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")

    # per-step log decay: a_t = dt_t * A  (negative)
    a = dt * A[None, None, :]                                  # [B,S,H]
    xr = xh.reshape(B_, nc, chunk, H, P)
    ar = a.reshape(B_, nc, chunk, H)
    dtr = dt.reshape(B_, nc, chunk, H)
    Br = Bc.reshape(B_, nc, chunk, N)
    Cr = Cc.reshape(B_, nc, chunk, N)

    # cumulative decay within chunk: L[t] = sum_{i<=t} a_i
    acs = torch.cumsum(ar, dim=2)                              # [B,nc,c,H]

    # ---- intra-chunk (quadratic, attention-like) ----
    # scores[t,s] = (C_t . B_s) * exp(acs_t - acs_s) * dt_s  for s <= t
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]       # [B,nc,c,c,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                        torch.zeros((), dtype=diff.dtype,
                                    device=diff.device))
    del diff
    cb = torch.einsum("bnck,bnmk->bncm", Cr, Br)               # C_t . B_s
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]     # [B,nc,c,c,H]
    del decay
    y_intra = torch.einsum("bncsh,bnshp->bnchp", scores, xr)
    del scores

    # ---- chunk-boundary states ----
    # state contribution of chunk j: sum_s exp(acs_end - acs_s) dt_s B_s x_s
    tail_decay = torch.exp(acs[:, :, -1:, :] - acs)            # [B,nc,c,H]
    chunk_state = torch.einsum("bnsh,bnsk,bnshp->bnhpk",
                               tail_decay * dtr, Br, xr)       # [B,nc,H,P,N]

    # scan over chunks: h_{j+1} = exp(sum a in chunk j) h_j + chunk_state_j
    chunk_decay = torch.exp(acs[:, :, -1, :])                  # [B,nc,H]
    h = torch.zeros((B_, H, P, N), dtype=xh.dtype, device=xh.device)
    h_before = []
    for j in range(nc):
        h_before.append(h)                          # state BEFORE chunk
        h = chunk_decay[:, j, :, None, None] * h + chunk_state[:, j]
    h_before = torch.stack(h_before, dim=1)                    # [B,nc,H,P,N]

    # ---- inter-chunk: y += C_t . (decay_to_t * h_before_chunk) ----
    head_decay = torch.exp(acs)                                # [B,nc,c,H]
    y_inter = torch.einsum("bnck,bnch,bnhpk->bnchp",
                           Cr, head_decay, h_before)
    y = (y_intra + y_inter).reshape(B_, S, H, P)
    y = y + xh * D[None, None, :, None]
    return y, h
