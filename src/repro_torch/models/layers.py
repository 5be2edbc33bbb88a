"""Shared neural layers (plain torch): norms, activations, RoPE, loss.

Conventions, as in the JAX package:
  * params are plain nested dicts of tensors, stored in ``param_dtype``
    (fp32 by default) and cast to ``compute_dtype`` (bf16) inside ops;
  * RoPE uses the *interleaved-pairs* formulation (GPT-NeoX style): pairs
    ``(2i, 2i+1)`` rotate together, not the rotate-half split.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in fp32; ``zero_centered`` uses the Gemma (1+scale)
    convention."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if zero_centered:
        w = 1.0 + w
    return (y * w).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` is torch's tanh approximation."""
    return F.gelu(gate, approximate="tanh") * up


ACTIVATIONS = {"swiglu": swiglu, "geglu": geglu}


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved-pairs formulation).
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies, shape [head_dim // 2], fp32."""
    k = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (2.0 * k / head_dim))


def _rotate_pairs(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (2i, 2i+1) of x [..., S, H, D] by ang [..., S, D/2]."""
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x_even = x32[..., 0::2]
    x_odd = x32[..., 1::2]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_odd * cos + x_even * sin
    out = torch.stack([out_even, out_odd], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # [D/2]
    ang = positions[..., None].float() * inv                  # [..., S, D/2]
    return _rotate_pairs(x, ang)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL proportions (16, 24, 24)/64 of the pair dim, any head_dim."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Optional[Tuple[int, int, int]] = None,
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the pair dimension is split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  ``positions``: [3, ..., S]; x: [..., S, H, D] with
    sum(sections) == D // 2."""
    D = x.shape[-1]
    if sections is None:
        sections = mrope_sections(D)
    assert sum(sections) == D // 2, (sections, D)
    inv = rope_freqs(D, theta, x.device)                      # [D/2]
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(sections, device=positions.device),
        output_size=D // 2)                                   # [D/2]
    pos = torch.movedim(positions[sec_id], 0, -1)             # [..., S, D/2]
    return _rotate_pairs(x, pos.float() * inv)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE in fp32. logits [..., V], labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
