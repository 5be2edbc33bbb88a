"""Plain torch version of the SSD kernel: the port of the JAX package's
``models.ssm.ssd_chunked`` (which its ``kernels/ssd_scan/ref.py``
re-exports as the kernel's oracle).  ``models/ssm.py`` re-exports it as
``ssd_chunked``; it lives here so that ``models/ssm.py`` can import the
kernel's front end without an import cycle.

It computes in the inputs' dtype, as the JAX function does: bf16 inputs
give bf16 intermediates and a bf16 state.  ``lax.scan`` over the chunks
becomes a Python loop.  ``ops`` runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.

Below it, the plain version of each pass of the bf16 kernel of
``csrc/ssd_passes.cu`` (``chunk_state``, ``state_pass``, ``chunk_out``),
in fp32, whose composition ``ssd_passes`` is the same scan.  Given
``operand_dtype=torch.bfloat16`` they round what that kernel rounds (the
operands of its products: x exp(acs_end - acs) dt, B, C, x, h_before and
the scores) and nothing else.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _rounded(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` in fp32, rounded through ``dtype`` first where one is given."""
    return t.float() if dtype is None else t.to(dtype).float()


def chunk_cumsum(dt: torch.Tensor, A: torch.Tensor, chunk: int
                 ) -> torch.Tensor:
    """acs [B,H,nc,c]: the cumulative sum of dt_t A within each chunk, fp32."""
    B_, S, H = dt.shape
    a = dt.float() * A.float()[None, None, :]
    return torch.cumsum(a.reshape(B_, S // chunk, chunk, H),
                        dim=2).permute(0, 3, 1, 2)


def chunk_state(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, chunk: int,
                operand_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1.  states [B,nc,H,P,N] = sum_s (x_s exp(acs_end - acs_s) dt_s)
    B_s^T within each chunk, and chunk_sum [B,H,nc] = acs_end; fp32."""
    B_, S, H, P = xh.shape
    N, nc = Bc.shape[-1], S // chunk
    acs = chunk_cumsum(dt, A, chunk)                           # [B,H,nc,c]
    dtr = dt.float().reshape(B_, nc, chunk, H).permute(0, 3, 1, 2)
    tail = torch.exp(acs[..., -1:] - acs) * dtr                # [B,H,nc,c]
    xw = _rounded(xh.float().reshape(B_, nc, chunk, H, P)
                  * tail.permute(0, 2, 3, 1)[..., None], operand_dtype)
    Br = _rounded(Bc, operand_dtype).reshape(B_, nc, chunk, N)
    states = torch.einsum("bnshp,bnsk->bnhpk", xw, Br)
    return states, acs[..., -1].contiguous()


def state_pass(states: torch.Tensor, chunk_sum: torch.Tensor,
               operand_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2.  h_before [B,nc,H,P,N], the state before each chunk (in
    ``operand_dtype`` where given, else fp32), and h_final [B,H,P,N] fp32:
    h <- exp(chunk_sum_j) h + states_j from h = 0."""
    decay = torch.exp(chunk_sum.float())                       # [B,H,nc]
    h = torch.zeros_like(states[:, 0], dtype=torch.float32)
    h_before = []
    for j in range(states.shape[1]):
        h_before.append(h if operand_dtype is None else h.to(operand_dtype))
        h = decay[:, :, j, None, None] * h + states[:, j].float()
    return torch.stack(h_before, dim=1), h


def chunk_out(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
              h_before: torch.Tensor, chunk: int,
              operand_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Pass 3.  y [B,S,H,P] in xh's dtype: exp(acs_t) C_t . h_before_j
    + sum_{s <= t} (C_t . B_s) exp(acs_t - acs_s) dt_s x_s + D x_t."""
    B_, S, H, P = xh.shape
    N, nc = Bc.shape[-1], S // chunk
    acs = chunk_cumsum(dt, A, chunk)                           # [B,H,nc,c]
    Cr = _rounded(Cc, operand_dtype).reshape(B_, nc, chunk, N)
    Br = _rounded(Bc, operand_dtype).reshape(B_, nc, chunk, N)
    xr = _rounded(xh, operand_dtype).reshape(B_, nc, chunk, H, P)
    dtr = dt.float().reshape(B_, nc, chunk, H).permute(0, 3, 1, 2)
    cb = torch.einsum("bntk,bnsk->bnts", Cr, Br)               # [B,nc,c,c]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    diff = acs[..., :, None] - acs[..., None, :]               # [B,H,nc,t,s]
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.)), 0.)
    scores = _rounded(cb[:, None] * decay * dtr[..., None, :], operand_dtype)
    y = torch.einsum("bhnts,bnshp->bnthp", scores, xr)
    hb = _rounded(h_before, operand_dtype)                     # [B,nc,H,P,N]
    y = y + torch.einsum("bntk,bnhpk->bnthp", Cr, hb) \
        * torch.exp(acs).permute(0, 2, 3, 1)[..., None]
    y = y.reshape(B_, S, H, P) + xh.float() * D.float()[None, None, :, None]
    return y.to(xh.dtype)


def ssd_passes(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
               chunk: int, operand_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three passes composed: (y [B,S,H,P] in xh's dtype, h_final
    [B,H,P,N] fp32), the same function as ``ssd_chunked``."""
    states, chunk_sum = chunk_state(xh, dt, A, Bc, chunk, operand_dtype)
    h_before, h_final = state_pass(states, chunk_sum, operand_dtype)
    return chunk_out(xh, dt, A, Bc, Cc, D, h_before, chunk,
                     operand_dtype), h_final
