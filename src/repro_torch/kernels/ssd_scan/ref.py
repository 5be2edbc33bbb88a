"""Plain torch version of the SSD kernel: the port of the JAX package's
``models.ssm.ssd_chunked`` (which its ``kernels/ssd_scan/ref.py``
re-exports as the kernel's oracle).  ``models/ssm.py`` re-exports it as
``ssd_chunked``; it lives here so that ``models/ssm.py`` can import the
kernel's front end without an import cycle.

It computes in the inputs' dtype, as the JAX function does: bf16 inputs
give bf16 intermediates and a bf16 state.  ``lax.scan`` over the chunks
becomes a Python loop.  One difference: the intra-chunk decay takes exp of
the masked difference only, so that its gradient stays finite where
exp(acs_t - acs_s) above the diagonal overflows (a chunk whose total log
decay passes 88 in fp32, as mamba2-780m's do at chunk 256); the JAX
function's gradient is NaN there.  Values are the same.  ``ops`` runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.

Below it, the plain version of each pass of the bf16 kernel of
``csrc/ssd_passes.cu`` (``chunk_state``, ``state_pass``, ``chunk_out``),
in fp32, whose composition ``ssd_passes`` is the same scan.  Given
``operand_dtype=torch.bfloat16`` they round what that kernel rounds (the
operands of its products: x exp(acs_end - acs) dt, B, C, x, h_before and
the scores) and nothing else.

Last, the plain version of each pass of the backward kernel of
``csrc/ssd_scan_bwd.cu``, in fp32, whose composition ``ssd_passes_bwd`` is
the gradient of the scan: ``state_grad_from_y`` (what y asks of the state
before each chunk), ``state_pass_bwd`` (the state's gradient carried from
the last chunk to the first), ``chunk_bwd`` (every local gradient of a
chunk) and ``reduce_bwd`` (the sums over heads and over (batch,
sequence)).  That kernel computes in fp32 from the upcast inputs and
rounds no operand of its own; what it reads that was rounded is the
forward's fp32 state before each chunk, whose chunk states the bf16
forward formed from bf16 operands.  ``operand_dtype`` rounds that (through
``chunk_state``) and nothing else.

The bf16 backward on ``wgmma`` (``csrc/ssd_scan_bwd_wgmma.cu``) takes the
same state passes and, in place of ``chunk_bwd`` and ``reduce_bwd``,
``chunk_bwd_summed``: dB and dC come from dCB summed over the heads, and
the heads' state terms are summed as they are formed.  Its products round
their fp32 operands to bf16, and ``ssd_passes_bwd(..., path="wgmma")``
with an ``operand_dtype`` rounds exactly those, besides the forward's
chunk-state operands: exp(acs_t) dy_t (``state_grad_from_y``'s dh_y, dC's
head term and the acs gradient's inter term), h_before (dC's head term,
the inter term), dS (dx's and dB's state terms and <x B^T, dS>),
tail_s x_s (dB's state term) and the scores C B^T L dt_s (dx); the
head-summed dCB (dB, dC) as two terms, hi = the rounded dCB and lo = the
rounded rest.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
    # exp of the masked difference only: above the diagonal exp(acs_t -
    # acs_s) overflows once the chunk's decay passes 88 (fp32), and the
    # gradient of a where over an inf is NaN (0 * inf) though its value is 0
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]       # [B,nc,c,c,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)
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


def ssd_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's oracle in its argument order: xh [B,S,H,P], dt [B,S,H]
    (softplus-ed), A [H] (<0), Bc/Cc [B,S,N], D [H] -> (y [B,S,H,P],
    h_final [B,H,P,N]); ``ssd_chunked`` itself."""
    return ssd_chunked(xh, dt, A, Bc, Cc, D, chunk)


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


# ---------------------------------------------------------------------------
# the backward's passes (csrc/ssd_scan_bwd.cu)
# ---------------------------------------------------------------------------

def state_grad_from_y(dy: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Cc: torch.Tensor, chunk: int,
                      operand_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass (a).  dh_y [B,nc,H,P,N] = sum_t exp(acs_t) dy_t^T C_t
    within each chunk (what y asks of the state before the chunk), and
    chunk_sum [B,H,nc] = acs_end; fp32.  ``operand_dtype`` rounds
    exp(acs_t) dy_t, as the wgmma backward does."""
    B_, S, H, P = dy.shape
    N, nc = Cc.shape[-1], S // chunk
    acs = chunk_cumsum(dt, A, chunk)                           # [B,H,nc,c]
    dyw = _rounded(dy.float().reshape(B_, nc, chunk, H, P) *
                   torch.exp(acs).permute(0, 2, 3, 1)[..., None],
                   operand_dtype)
    Cr = Cc.float().reshape(B_, nc, chunk, N)
    return torch.einsum("bnthp,bntk->bnhpk", dyw, Cr), \
        acs[..., -1].contiguous()


def state_pass_bwd(dh_y: torch.Tensor, chunk_sum: torch.Tensor,
                   dh_final: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backward pass (b).  dstates [B,nc,H,P,N] fp32, the gradient of the
    state after each chunk (of the chunk's state sum S_j): g <- dh_final
    (zero where None), then from the last chunk to the first dstates_j = g
    and g <- dh_y_j + exp(chunk_sum_j) g."""
    decay = torch.exp(chunk_sum.float())                       # [B,H,nc]
    g = torch.zeros_like(dh_y[:, 0]) if dh_final is None \
        else dh_final.float().expand_as(dh_y[:, 0])
    out = [None] * dh_y.shape[1]
    for j in reversed(range(dh_y.shape[1])):
        out[j] = g
        g = dh_y[:, j] + decay[:, :, j, None, None] * g
    return torch.stack(out, dim=1)


def chunk_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
              h_before: torch.Tensor, dstates: torch.Tensor,
              dy: torch.Tensor, chunk: int) -> Dict[str, torch.Tensor]:
    """Backward pass (c): every local gradient of each (batch, chunk,
    head), fp32, with L[t,s] = exp(acs_t - acs_s) [s <= t], CB = C B^T,
    G = dy x^T, tail_s = exp(acs_end - acs_s) dt_s, h = h_before_j and
    dS = dstates_j:

    - dx_s = sum_t CB L dt_s dy_t + tail_s dS B_s + D dy_s;
    - dCB = G L dt_s (per head), so dC_t = dCB B + exp(acs_t) dy_t h and
      dB_s = dCB^T C + tail_s x_s dS;
    - the direct ddt_s = sum_t CB L G + exp(acs_end - acs_s) <x_s B_s^T,
      dS>, and the gradient of acs from L, from exp(acs_t) of the
      inter-chunk term, from the tail and from the decay exp(acs_end) of
      h into the next chunk, exp(acs_end) <h, dS>;
    - da = the reverse cumulative sum of dacs within the chunk, ddt +=
      A da, and the chunk's parts of dA (sum_s dt_s da_s) and dD
      (sum_t dy_t . x_t).

    Returns dxh [B,S,H,P], ddt [B,S,H], dB_heads and dC_heads [B,S,H,N]
    (each head's part: B and C are shared by the heads), dA_part and
    dD_part [B,H,nc]."""
    B_, S, H, P = xh.shape
    N, nc = Bc.shape[-1], S // chunk
    acs = chunk_cumsum(dt, A, chunk)                           # [B,H,nc,c]
    acs_end = acs[..., -1:]
    dtr = dt.float().reshape(B_, nc, chunk, H).permute(0, 3, 1, 2)
    x = xh.float().reshape(B_, nc, chunk, H, P)
    g = dy.float().reshape(B_, nc, chunk, H, P)
    Br = Bc.float().reshape(B_, nc, chunk, N)
    Cr = Cc.float().reshape(B_, nc, chunk, N)
    hb, dS = h_before.float(), dstates.float()                # [B,nc,H,P,N]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    diff = acs[..., :, None] - acs[..., None, :]               # [B,H,nc,t,s]
    Lm = torch.where(mask, torch.exp(torch.where(mask, diff, 0.)), 0.)
    cb = torch.einsum("bntk,bnsk->bnts", Cr, Br)[:, None]      # [B,1,nc,t,s]
    G = torch.einsum("bnthp,bnshp->bhnts", g, x)
    Ldt = Lm * dtr[..., None, :]
    E = cb * Lm * G                                            # CB L G
    dCB = G * Ldt
    w = torch.exp(acs_end - acs)                               # [B,H,nc,c]
    tail = w * dtr
    eacs = torch.exp(acs)

    def rows(t):                                    # [B,H,nc,c] -> rows
        return t.permute(0, 2, 3, 1)[..., None]     # [B,nc,c,H,1]

    dx = torch.einsum("bhnts,bnthp->bnshp", cb * Ldt, g) + \
        torch.einsum("bnsk,bnhpk->bnshp", Br, dS) * rows(tail) + \
        g * D.float()[None, None, None, :, None]
    dC_inter = torch.einsum("bnthp,bnhpk->bnthk", g, hb) * rows(eacs)
    dC = torch.einsum("bhnts,bnsk->bnthk", dCB, Br) + dC_inter
    xdS = torch.einsum("bnshp,bnhpk->bnshk", x, dS)
    dB = torch.einsum("bhnts,bntk->bnshk", dCB, Cr) + xdS * rows(tail)
    Q = torch.einsum("bnsk,bnshk->bhns", Br, xdS)              # <x B^T, dS>
    M = E * dtr[..., None, :]
    dacs = M.sum(-1) - M.sum(-2) - tail * Q + \
        torch.einsum("bntk,bnthk->bhnt", Cr, dC_inter)
    end = (tail * Q).sum(-1) + torch.exp(acs_end[..., 0]) * \
        torch.einsum("bnhpk,bnhpk->bhn", hb, dS)
    dacs = torch.cat([dacs[..., :-1], dacs[..., -1:] + end[..., None]], -1)
    da = dacs.flip(-1).cumsum(-1).flip(-1)
    ddt = E.sum(-2) + w * Q + A.float()[None, :, None, None] * da
    return {"dxh": dx.reshape(B_, S, H, P),
            "ddt": ddt.permute(0, 2, 3, 1).reshape(B_, S, H),
            "dB_heads": dB.reshape(B_, S, H, N),
            "dC_heads": dC.reshape(B_, S, H, N),
            "dA_part": (dtr * da).sum(-1),
            "dD_part": torch.einsum("bnthp,bnthp->bhn", g, x)}


def chunk_bwd_summed(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                     h_before: torch.Tensor, dstates: torch.Tensor,
                     dy: torch.Tensor, chunk: int,
                     operand_dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """The wgmma backward's chunk passes: ``chunk_bwd``'s function with dB
    and dC summed over the heads as the kernels form them, dB_s = sum_t
    dCB[t,s] C_t + sum_h tail_s x_s dS and dC_t = sum_s dCB[t,s] B_s +
    sum_h exp(acs_t) dy_t h with dCB = sum_h G L dt_s.  ``operand_dtype``
    rounds each product's fp32 operand (the module note lists them; dCB
    as the sum of two rounded terms).
    Returns dxh [B,S,H,P], ddt [B,S,H], dBc and dCc [B,S,N], dA_part and
    dD_part [B,H,nc] (fp32), and dcb [B,nc,c,c], the head-summed dCB; in
    fp32 it is ``reduce_bwd`` of ``chunk_bwd`` up to fp32 rounding."""
    B_, S, H, P = xh.shape
    N, nc = Bc.shape[-1], S // chunk
    acs = chunk_cumsum(dt, A, chunk)                           # [B,H,nc,c]
    acs_end = acs[..., -1:]
    dtr = dt.float().reshape(B_, nc, chunk, H).permute(0, 3, 1, 2)
    x = xh.float().reshape(B_, nc, chunk, H, P)
    g = dy.float().reshape(B_, nc, chunk, H, P)
    Br = Bc.float().reshape(B_, nc, chunk, N)
    Cr = Cc.float().reshape(B_, nc, chunk, N)
    hb, dS = h_before.float(), dstates.float()                # [B,nc,H,P,N]

    def rnd(t):
        return _rounded(t, operand_dtype)

    def rows(t):                                    # [B,H,nc,c] -> rows
        return t.permute(0, 2, 3, 1)[..., None]     # [B,nc,c,H,1]

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    diff = acs[..., :, None] - acs[..., None, :]               # [B,H,nc,t,s]
    Lm = torch.where(mask, torch.exp(torch.where(mask, diff, 0.)), 0.)
    del diff
    cb = torch.einsum("bntk,bnsk->bnts", Cr, Br)[:, None]      # [B,1,nc,t,s]
    G = torch.einsum("bnthp,bnshp->bhnts", g, x)
    Ldt = Lm * dtr[..., None, :]
    E = cb * Lm * G                                            # CB L G
    del Lm
    dcb = (G * Ldt).sum(1)                                     # [B,nc,t,s]
    del G
    scores = rnd(cb * Ldt)
    del Ldt
    tail = torch.exp(acs_end - acs) * dtr
    dSr, hbr = rnd(dS), rnd(hb)
    dye = rnd(g * rows(torch.exp(acs)))                        # e_t dy_t
    bds = torch.einsum("bnsk,bnhpk->bnshp", Br, dSr)           # B_s dS^T
    dx = torch.einsum("bhnts,bnthp->bnshp", scores, g) + bds * rows(tail) + \
        g * D.float()[None, None, None, :, None]
    del scores
    Q = (x * bds).sum(-1).permute(0, 3, 1, 2)                 # <x B^T, dS>
    del bds
    dcbr = rnd(dcb)
    dcbr = dcbr + rnd(dcb - dcbr)                   # hi + lo
    dC = torch.einsum("bnts,bnsk->bntk", dcbr, Br) + \
        torch.einsum("bnthp,bnhpk->bntk", dye, hbr)
    dB = torch.einsum("bnts,bntk->bnsk", dcbr, Cr) + \
        torch.einsum("bnshp,bnhpk->bnsk", rnd(x * rows(tail)), dSr)
    inter = (dye * torch.einsum("bntk,bnhpk->bnthp", Cr, hbr)).sum(-1) \
        .permute(0, 3, 1, 2)                                   # C.(e dy h)
    M = E * dtr[..., None, :]
    colE = E.sum(-2)                                           # over t
    del E
    dacs = M.sum(-1) - M.sum(-2) - tail * Q + inter
    del M
    end = (tail * Q).sum(-1) + torch.exp(acs_end[..., 0]) * \
        torch.einsum("bnhpk,bnhpk->bhn", hb, dS)
    dacs = torch.cat([dacs[..., :-1], dacs[..., -1:] + end[..., None]], -1)
    da = dacs.flip(-1).cumsum(-1).flip(-1)
    ddt = colE + torch.exp(acs_end - acs) * Q + \
        A.float()[None, :, None, None] * da
    return {"dxh": dx.reshape(B_, S, H, P),
            "ddt": ddt.permute(0, 2, 3, 1).reshape(B_, S, H),
            "dBc": dB.reshape(B_, S, N), "dCc": dC.reshape(B_, S, N),
            "dA_part": (dtr * da).sum(-1),
            "dD_part": torch.einsum("bnthp,bnthp->bhn", g, x),
            "dcb": dcb}


def reduce_bwd(parts: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Backward pass (d): dB and dC [B,S,N] summed over heads, dA and dD
    [H] over (batch, chunk); with pass (c)'s dxh and ddt, the six
    gradients (dxh, ddt, dA, dBc, dCc, dD), fp32."""
    return (parts["dxh"], parts["ddt"], parts["dA_part"].sum((0, 2)),
            parts["dB_heads"].sum(2), parts["dC_heads"].sum(2),
            parts["dD_part"].sum((0, 2)))


def ssd_passes_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   dy: torch.Tensor, dh_final: Optional[torch.Tensor],
                   chunk: int, operand_dtype: Optional[torch.dtype] = None,
                   path: str = "simple") -> Tuple[torch.Tensor, ...]:
    """The backward's passes composed: the gradient of ``ssd_chunked`` (y,
    h_final) for the cotangents dy [B,S,H,P] and dh_final [B,H,P,N] (None:
    zero), as (dxh, ddt, dA, dBc, dCc, dD), each in its input's dtype.
    The state before each chunk [B,nc,H,P,N] is recomputed by
    ``chunk_state`` (rounding as ``operand_dtype`` says) and ``state_pass``
    in fp32, as the kernel's forward writes it.  ``path`` names the kernel
    mirrored: ``"simple"`` (``chunk_bwd``, ``reduce_bwd``; the
    operand_dtype rounds only the forward's chunk-state operands) or
    ``"wgmma"`` (``chunk_bwd_summed``; it also rounds the operands the
    wgmma backward rounds)."""
    if path not in ("simple", "wgmma"):
        raise ValueError(f"unknown ssd_scan_bwd path {path!r}")
    states, chunk_sum = chunk_state(xh, dt, A, Bc, chunk, operand_dtype)
    h_before, _ = state_pass(states, chunk_sum)
    del states
    bwd_dtype = operand_dtype if path == "wgmma" else None
    dh_y, chunk_sum = state_grad_from_y(dy, dt, A, Cc, chunk, bwd_dtype)
    dstates = state_pass_bwd(dh_y, chunk_sum, dh_final)
    del dh_y
    if path == "wgmma":
        p = chunk_bwd_summed(xh, dt, A, Bc, Cc, D, h_before, dstates, dy,
                             chunk, bwd_dtype)
        grads = (p["dxh"], p["ddt"], p["dA_part"].sum((0, 2)), p["dBc"],
                 p["dCc"], p["dD_part"].sum((0, 2)))
    else:
        grads = reduce_bwd(chunk_bwd(xh, dt, A, Bc, Cc, D, h_before,
                                     dstates, dy, chunk))
    return tuple(g.to(t.dtype) for g, t in zip(grads,
                                                (xh, dt, A, Bc, Cc, D)))
