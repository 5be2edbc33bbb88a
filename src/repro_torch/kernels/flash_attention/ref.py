"""Plain torch versions for the flash-attention kernel.

``flash_attention_ref`` is the kernel's plain version: the same function on
the same layouts with the kernel's numerics (fp32 scores, the finite
NEG_INF, p rounded to v's dtype before p.v, division by the clamped
denominator last), materialising the [Sq, Sk] scores.  ``ops`` runs it for
CPU tensors and ``chip_smoke.py`` holds the kernel against it on the card.

``mha_ref`` is the twin of the JAX package's oracle
``kernels/flash_attention/ref.py::mha_ref``.

``row_scaled_err`` is the measure a bf16 result is held to: an output row
that averages n keys has an RMS near sqrt(e / n) for N(0, 1) inputs, so a
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
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), vf.float()) / l
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def row_scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over output rows (one query of one head) of max |got - want|
    over the row divided by the RMS of ``want`` over the row."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    rms = want.float().pow(2).mean(dim=-1).sqrt()
    return float((diff / rms.clamp_min(1e-30)).max()) if diff.numel() else 0.0


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
