"""Plain torch versions for the flash-attention kernel.

``flash_attention_ref`` is the kernel's plain version: the same function on
the same layouts with the kernel's numerics (fp32 scores, the finite
NEG_INF, p rounded to v's dtype before p.v, division by the clamped
denominator last), materialising the [Sq, Sk] scores.  ``ops`` runs it for
CPU tensors and ``chip_smoke.py`` holds the kernel against it on the card.

``flash_attention_bwd_ref`` is the backward kernel's plain version: the
gradient of ``flash_attention_ref`` by autograd.  ``flash_attention_stats_ref``
is the plain version of what the bf16 forward also writes for the backward
when autograd records it: the fp32 output before its rounding and each
row's logsumexp of its scores; ``delta_ref`` the backward's pre-pass,
rowsum(dO o O) from that fp32 output.

``mha_ref`` is the twin of the JAX package's oracle
``kernels/flash_attention/ref.py::mha_ref``.

``grad_row_err`` and ``grad_rms_err`` are the measures a bf16 gradient is
held to, the second against the exact gradient beside the plain version's
own.  ``row_scaled_err`` is the measure a bf16 result is held to: an output
row that averages n keys has an RMS near sqrt(e / n) for N(0, 1) inputs, so a
fixed absolute tolerance that fits the first rows is as large as the
values of the late ones.  ``BF16_ROW_TOL`` is its bound, 1.7 times the
largest reading of the CUDA kernel against this plain version (0.036 at
gemma2-9b's prefill shapes on an H100, where scaled_dot_product_attention
and FlexAttention read 0.031-0.037 against the kernel).  That is the
rounding of the output and of p: about one bf16 step (2^-8 of a value) of
a row's largest entries.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e38          # the kernel's masked value (_flash_kernel)
MHA_NEG_INF = -2.0e38      # mha_ref's
BF16_ROW_TOL = 2.0 ** -4   # row_scaled_err bound for bf16 results
#: grad_row_err bound for the backward kernel's bf16 gradients against
#: this plain version's: a coarse per-row gate (a row the kernel got wrong
#: reads near 1); BF16_GRAD_RMS_RATIO is the one that sees a small error
#: spread over the tensor.  Each side rounds in bf16 where the other does
#: not: the kernel rounds P and dS to bf16 as tensor-core operands, and the
#: plain version's autograd rounds dO.v / l to bf16 through p's cast (and
#: puts the residue on each row's argmax).  Where a row's attention sits on
#: one key, dq = scale sum_j P_ij (dO.v_j - delta) k_j nearly cancels and
#: carries such a rounding whole: against the plain version run in fp32 on
#: the upcast inputs (the exact function) either side reads up to about
#: 0.12 of the tensor's scale there (chip_smoke.py's flash_attention_bwd
#: rows, ``fp32_plain_row_scaled_err`` and ``plain_fp32_row_scaled_err``),
#: while the median row reads 0.005.  Their difference can reach the sum:
#: 2^-2.
BF16_GRAD_ROW_TOL = 2.0 ** -2
#: How much further from the exact gradient (this plain version in fp32 on
#: the upcast inputs) the backward kernel's bf16 gradient may be than this
#: plain version's own bf16 gradient, each by ``grad_rms_err``.  Each error
#: is a sum of independent roundings of about one bf16 step; the kernel
#: rounds at most once more in each product (P / l as dV's bf16 operand,
#: where the plain version multiplies fp32 by the bf16 p), so its squared
#: error is at most twice the plain version's: sqrt(2).  A systematic error
#: of 0.5% of a gradient reads 2 or more.
BF16_GRAD_RMS_RATIO = 2.0 ** 0.5


def _allowed(Sq: int, Sk: int, causal: bool, window: int, device,
             positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool [Sq, Sk]: may query i see key j.  Their positions are i and j,
    or ``positions[i]`` and ``positions[j]`` (one int vector [S] for both
    sides, Sq == Sk == S), compared in int64."""
    if positions is None:
        qp = torch.arange(Sq, device=device)[:, None]
        kp = torch.arange(Sk, device=device)[None, :]
    else:
        pos = positions.to(device=device, dtype=torch.int64)
        qp, kp = pos[:, None], pos[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


def _attention_f32(q, k, v, causal, window, softcap, scale, positions):
    """The plain version's fp32 output [B,KV,G,Sq,D], row maxima and
    denominators [B,KV,G,Sq,1] (see ``flash_attention_ref``)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale or D ** -0.5
    qf = q.float().reshape(B, Sq, KV, H // KV, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # [B,KV,1,Sk,D]
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale      # [B,KV,G,Sq,Sk]
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = _allowed(Sq, Sk, causal, window, q.device, positions)
    s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                        device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p.to(v.dtype).float(), vf.float()) / l, m, l


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        scale: Optional[float] = None,
                        positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q [B,Sq,H,D]; k, v [B,Sk,KV,D] -> [B,Sq,H,D] in q's dtype; query
    head h reads KV head h // (H // KV).  ``positions`` (int [S], with
    Sq == Sk == S) masks by position instead of by index."""
    B, Sq, H, D = q.shape
    out, _, _ = _attention_f32(q, k, v, causal, window, softcap, scale,
                               positions)
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def flash_attention_stats_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              scale: Optional[float] = None,
                              positions: Optional[torch.Tensor] = None):
    """(out32, lse): ``flash_attention_ref``'s output before its rounding
    to q's dtype (fp32 [B,Sq,H,D]) and each row's logsumexp over the keys
    of its masked scores (fp32 [B,H,Sq]; natural log, in the domain of
    the scaled and capped scores; a row with no key it may see reads
    NEG_INF + ln(Sk))."""
    B, Sq, H, D = q.shape
    out, m, l = _attention_f32(q, k, v, causal, window, softcap, scale,
                               positions)
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D),
            (m + torch.log(l)).reshape(B, H, Sq))


def delta_ref(out32: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The backward's delta: rowsum(dO o O) in fp32 from the fp32 output
    [B,Sq,H,D] and its gradient -> [B,H,Sq]."""
    return (dout.float() * out32.float()).sum(-1).permute(0, 2, 1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, **kw):
    """(dq, dk, dv): ``torch.autograd.grad`` of ``flash_attention_ref(q, k,
    v, **kw)`` against ``dout``, in the inputs' dtypes.  ``out`` (the
    forward's output, which the kernel reads) is taken for the kernel's
    signature; the plain version recomputes it."""
    del out
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        got = flash_attention_ref(*leaves, **kw)
        return torch.autograd.grad(got, leaves, dout)


def row_scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over output rows (one query of one head) of max |got - want|
    over the row divided by the RMS of ``want`` over the row."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    rms = want.float().pow(2).mean(dim=-1).sqrt()
    return float((diff / rms.clamp_min(1e-30)).max()) if diff.numel() else 0.0


def grad_row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``row_scaled_err`` with each row's RMS floored at the whole tensor's
    RMS: the measure a bf16 gradient is held to.  A gradient row can be 0
    up to rounding (a causal first query's dq: its only key gives
    dS = P (dO.v - dO.o) = 0), and its error is then read against the
    tensor's scale."""
    w = want.float()
    diff = (got.float() - w).abs().amax(dim=-1)
    if not diff.numel():
        return 0.0
    floor = max(float(w.pow(2).mean().sqrt()), 1e-30)
    rms = w.pow(2).mean(dim=-1).sqrt().clamp_min(floor)
    return float((diff / rms).max())


def grad_rms_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The RMS of ``got - want`` over the RMS of ``want``, over the whole
    tensor: a bf16 gradient's rounding averaged, so a systematic error of
    a fraction of a percent stands out from it."""
    w = want.float()
    num = float((got.float() - w).pow(2).mean().sqrt()) if w.numel() else 0.
    return num / max(float(w.pow(2).mean().sqrt()) if w.numel() else 0.,
                     1e-30)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0, softcap: float = 0.0,
            scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,Sq,D]; k, v [B,H,Sk,D] (KV already expanded to H)
    -> [B,H,Sq,D]: the naive softmax with mha_ref's masking."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = scale or D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(_allowed(Sq, Sk, causal, window, q.device)[None, None],
                    s, torch.tensor(MHA_NEG_INF, dtype=s.dtype,
                                    device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)
