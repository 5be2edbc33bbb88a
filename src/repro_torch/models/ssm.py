"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), plain torch with
the chunked scan in the ``ssd_scan`` kernel.

The selective state-space layer with scalar-identity A per head:

    h_t = exp(dt_t·A) * h_{t-1} + dt_t * B_t ⊗ x_t          (per head)
    y_t = C_t · h_t + D * x_t

Prefill and training (``ssm_forward``) always go through the kernels'
front end ``ssd_scan``: the hand-written CUDA kernels for tensors on the
card (the forward scan, and where autograd records the call its
hand-written backward), their plain torch version ``ssd_chunked``
(re-exported here) for tensors on the CPU, whose gradient autograd takes.
Decode is the O(1) recurrence in plain torch, as in the JAX package, which
has no decode kernel.

Projections stay *separate* (z, x, B, C, dt), as in the JAX package (its
tensor-parallel note, DESIGN.md §6).  Decode applies the JAX package's
decode_tp constraints (``sharding_ctx.constrain``), which act only on
``DTensor``s in the dry run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from ..kernels.ssd_scan.ref import ssd_chunked
from .layers import rms_norm
from .sharding_ctx import constrain

__all__ = ["SSMSpec", "init_ssm_params", "ssm_forward", "ssd_chunked",
           "init_ssm_cache", "decode_ssm"]


@dataclass(frozen=True)
class SSMSpec:
    d_inner: int                  # expand * d_model
    n_heads: int                  # d_inner // headdim
    headdim: int
    d_state: int                  # N
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


def init_ssm_params(gen: torch.Generator, d_model: int, spec: SSMSpec,
                    dtype, *, lead: Tuple[int, ...] = (),
                    device=None) -> Dict:
    """The JAX package's names, shapes, scales and dtypes (``dt_bias``,
    ``A_log`` and ``D`` stay fp32); ``lead`` prepends stacking axes (the
    groups of ``lm.init_params``)."""
    Din, H, N, W = spec.d_inner, spec.n_heads, spec.d_state, spec.conv_width

    def normal(shape, s):
        return torch.randn(lead + shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(s).to(dtype)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    s = d_model ** -0.5
    u = torch.rand(lead + (H,), generator=gen, device=device,
                   dtype=torch.float32)
    dt = torch.exp(u * (math.log(spec.dt_max) - math.log(spec.dt_min))
                   + math.log(spec.dt_min))
    A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=device)).expand(lead + (H,))
    return {
        "in_z": normal((d_model, Din), s),
        "in_x": normal((d_model, Din), s),
        "in_B": normal((d_model, N), s),
        "in_C": normal((d_model, N), s),
        "in_dt": normal((d_model, H), s),
        "conv_x": normal((W, Din), W ** -0.5),
        "conv_B": normal((W, N), W ** -0.5),
        "conv_C": normal((W, N), W ** -0.5),
        "conv_bias_x": full((Din,), 0.0),
        "conv_bias_B": full((N,), 0.0),
        "conv_bias_C": full((N,), 0.0),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": A_log.contiguous(),
        "D": full((H,), 1.0, torch.float32),
        "norm": full((Din,), 1.0),
        "out_proj": normal((Din, d_model), Din ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over [B,S,Ch] with width-W filter [W,Ch].
    If ``state`` [B, W-1, Ch] is given (decode), uses it as left context and
    returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (W - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
        ctx = torch.cat([pad, x], dim=1)
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = ctx[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + ctx[:, i:i + S] * w[i].to(x.dtype)
    out = F.silu(out + b.to(x.dtype))
    new_state = ctx[:, -(W - 1):]
    return out, new_state


def _project(params, x):
    """x [B,S,d] -> z, xs [B,S,Din], Bc, Cc [B,S,N], dt [B,S,H]."""
    z = torch.einsum("bsd,de->bse", x, params["in_z"].to(x.dtype))
    xs = torch.einsum("bsd,de->bse", x, params["in_x"].to(x.dtype))
    Bc = torch.einsum("bsd,dn->bsn", x, params["in_B"].to(x.dtype))
    Cc = torch.einsum("bsd,dn->bsn", x, params["in_C"].to(x.dtype))
    dt = torch.einsum("bsd,dh->bsh", x, params["in_dt"].to(x.dtype))
    return z, xs, Bc, Cc, dt


def ssm_forward(params: Dict, x: torch.Tensor, spec: SSMSpec
                ) -> torch.Tensor:
    """Training / prefill forward. x: [B,S,d] -> [B,S,d]."""
    H, P = spec.n_heads, spec.headdim
    z, xs, Bc, Cc, dt = _project(params, x)
    xs, _ = _causal_conv(xs, params["conv_x"], params["conv_bias_x"])
    Bc, _ = _causal_conv(Bc, params["conv_B"], params["conv_bias_B"])
    Cc, _ = _causal_conv(Cc, params["conv_C"], params["conv_bias_C"])
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                            # [H] negative
    xh = xs.reshape(*xs.shape[:2], H, P)                       # a view
    y, _ = ssd_scan(xh, dt.to(x.dtype), A.to(x.dtype), Bc, Cc,
                    params["D"].to(x.dtype), chunk=spec.chunk)
    y = y.reshape(*x.shape[:2], spec.d_inner)
    y = rms_norm(y * F.silu(z), params["norm"])
    return torch.einsum("bse,ed->bsd", y, params["out_proj"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode (O(1) recurrent step)
# ---------------------------------------------------------------------------

def init_ssm_cache(batch: int, spec: SSMSpec, dtype, *,
                   lead: Tuple[int, ...] = (),
                   device=None) -> Dict[str, torch.Tensor]:
    H, P, N, W = spec.n_heads, spec.headdim, spec.d_state, spec.conv_width

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {"conv_x": zeros(batch, W - 1, spec.d_inner),
            "conv_B": zeros(batch, W - 1, N),
            "conv_C": zeros(batch, W - 1, N),
            "ssd": zeros(batch, H, P, N)}


def decode_ssm(params: Dict, x: torch.Tensor, cache: Dict, spec: SSMSpec
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: x [B,1,d] -> (y [B,1,d], cache).

    Unlike the JAX package, which returns an updated copy, the port writes
    the new conv windows and state into ``cache`` in place (a slot of the
    stacked cache) and returns the same dict."""
    H, P = spec.n_heads, spec.headdim
    z, xs, Bc, Cc, dt = _project(params, x)
    # decode_tp: pin the inner-dim activations to the stationary weight
    # layout so the out_proj contraction reduces activations instead of
    # gathering weights (no-op outside decode_tp mode)
    z = constrain(z, "batch", None, "tp")
    xs = constrain(xs, "batch", None, "tp")
    xs, conv_x = _causal_conv(xs, params["conv_x"], params["conv_bias_x"],
                              state=cache["conv_x"])
    Bc, conv_B = _causal_conv(Bc, params["conv_B"], params["conv_bias_B"],
                              state=cache["conv_B"])
    Cc, conv_C = _causal_conv(Cc, params["conv_C"], params["conv_bias_C"],
                              state=cache["conv_C"])
    dt = F.softplus(dt.float() + params["dt_bias"])            # [B,1,H]
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(-1, H, P)                                  # [B,H,P]
    decay = torch.exp(dt[:, 0, :] * A[None, :])                # [B,H]
    h = cache["ssd"].float()
    h = decay[..., None, None] * h + torch.einsum(
        "bh,bk,bhp->bhpk", dt[:, 0, :], Bc[:, 0].float(), xh.float())
    y = torch.einsum("bk,bhpk->bhp", Cc[:, 0].float(), h)
    y = y + xh.float() * params["D"][None, :, None]
    y = y.reshape(-1, 1, spec.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    y = constrain(y, "batch", None, "tp")
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(x.dtype))
    cache["conv_x"].copy_(conv_x)
    cache["conv_B"].copy_(conv_B)
    cache["conv_C"].copy_(conv_C)
    cache["ssd"].copy_(h)
    return out, cache
