"""Attention: GQA/MQA, sliding windows, logit softcap, qk-norm, RoPE/M-RoPE.

Shapes: x [B, S, d]; weights wq [d, H, Dh], wk/wv [d, KVH, Dh],
wo [H, Dh, d], as in the JAX package.

``attention`` (training / prefill) always goes through the flash kernel's
front end ``gqa_flash_attention``: the hand-written CUDA kernel for tensors
on the card, its plain torch version for tensors on the CPU.
``_attend_naive`` and ``_attend_chunked`` are the twins of the JAX
package's jnp paths; the tests hold the kernel's front end against them,
and the card's path never calls them.

GQA is computed with *grouped* contractions: query heads are reshaped to
[KV, G] groups and contracted against the un-expanded KV tensors, so the
decode cache is never repeated H/KV times.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import gqa_flash_attention
from .layers import apply_mrope, apply_rope, rms_norm, softcap
from .sharding_ctx import constrain

NEG_INF = -2.0e38


@dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    sliding_window: int = 0       # 0 = full attention
    causal: bool = True
    mrope: bool = False
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)


def init_attn_params(gen: torch.Generator, d_model: int, spec: AttnSpec,
                     dtype, *, lead: Tuple[int, ...] = (),
                     device=None) -> Dict:
    """The JAX package's shapes and scales; ``lead`` prepends stacking
    axes (the groups of ``lm.init_params``)."""
    H, KV, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    s = d_model ** -0.5

    def normal(*shape):
        return torch.randn(lead + shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(s).to(dtype)

    p = {"wq": normal(d_model, H, Dh), "wk": normal(d_model, KV, Dh),
         "wv": normal(d_model, KV, Dh), "wo": normal(H, Dh, d_model)}
    if spec.qk_norm:
        p["q_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, spec: AttnSpec, positions):
    """Returns q [B,S,H,Dh], k/v [B,S,KV,Dh] with rope + qk-norm applied."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if spec.mrope:
        q = apply_mrope(q, positions, theta=spec.rope_theta)
        k = apply_mrope(k, positions, theta=spec.rope_theta)
    else:
        q = apply_rope(q, positions, theta=spec.rope_theta)
        k = apply_rope(k, positions, theta=spec.rope_theta)
    return q, k, v


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,Dh] -> [B,S,KV,G,Dh] with G = H // KV."""
    B, S, H, Dh = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, Dh)


def _mask_bias(q_pos, k_pos, spec: AttnSpec) -> torch.Tensor:
    """Additive bias [Sq, Sk] encoding causality + sliding window."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if spec.causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if spec.sliding_window:
        ok &= k_pos[None, :] > q_pos[:, None] - spec.sliding_window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _attend_naive(qg, k, v, q_pos, k_pos, spec: AttnSpec) -> torch.Tensor:
    """Reference S²-materializing attention. qg [B,Sq,KV,G,Dh]."""
    scale = spec.query_scale or spec.head_dim ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    if spec.attn_softcap:
        scores = softcap(scores, spec.attn_softcap)
    scores = scores + _mask_bias(q_pos, k_pos, spec)[None, None, None]
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _attend_chunked(qg, k, v, q_pos, k_pos, spec: AttnSpec,
                    chunk: int, unroll: bool = False) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the XLA-level flash
    formulation): same math as _attend_naive.  ``unroll`` is accepted for
    the JAX signature; a Python loop has nothing to unroll."""
    B, Sq, KV, G, Dh = qg.shape
    Sk = k.shape[1]
    nc = Sk // chunk
    assert nc * chunk == Sk, (Sk, chunk)
    scale = spec.query_scale or spec.head_dim ** -0.5
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, KV, G, Sq, Dh), dtype=torch.float32,
                      device=qg.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k[:, sl]).float() * scale
        if spec.attn_softcap:
            s = softcap(s, spec.attn_softcap)
        s = s + _mask_bias(q_pos, k_pos[sl], spec)[None, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(qg.dtype), v[:, sl]).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # [B,KV,G,Sq,Dh]
    return torch.movedim(out, 3, 1).to(qg.dtype)              # [B,Sq,KV,G,Dh]


def _default_positions(B: int, S: int, spec: AttnSpec, device):
    pos1d = torch.arange(S, dtype=torch.int32, device=device)
    shape = (3, B, S) if spec.mrope else (B, S)
    return pos1d.expand(shape)


def attention(params: Dict, x: torch.Tensor, spec: AttnSpec, *,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: [B, S, d].

    RoPE takes ``positions``.  The masks, as in the JAX package's default
    path, take the temporal row of batch row 0 (``positions[0][0]`` for
    M-RoPE's [3, B, S], ``positions[0]`` for [B, S]) for queries and keys
    alike; without ``positions`` they count from 0 (the kernel's index
    masks, the fast case)."""
    B, S, _ = x.shape
    mask_pos = None
    if positions is None:
        positions = _default_positions(B, S, spec, x.device)
    else:
        mask_pos = (positions[0] if spec.mrope else positions)[0]
        mask_pos = mask_pos.to(torch.int32).contiguous()
    q, k, v = _project_qkv(params, x, spec, positions)
    ctx = gqa_flash_attention(
        q, k, v, causal=spec.causal, window=spec.sliding_window,
        softcap=spec.attn_softcap, scale=spec.query_scale,
        positions=mask_pos)
    return torch.einsum("bqhk,hkd->bqd", ctx, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode path with KV cache.
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, spec: AttnSpec, dtype, *,
                  lead: Tuple[int, ...] = (),
                  device=None) -> Dict[str, torch.Tensor]:
    KV, Dh = spec.n_kv_heads, spec.head_dim
    shape = lead + (batch, max_len, KV, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params: Dict, x: torch.Tensor, cache: Dict,
                     pos: int, spec: AttnSpec
                     ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x: [B, 1, d]; cache k/v [B, Smax, KV, Dh];
    pos: the index being written.

    Unlike the JAX package, which returns an updated copy, the port writes
    the new key and value into ``cache`` in place (a slot of the stacked
    cache) and returns the same dict: a copy per step would move the whole
    cache."""
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    pos_t = torch.full((3, B, 1) if spec.mrope else (B, 1), int(pos),
                       dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, spec, pos_t)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    qg = _group_q(q, spec.n_kv_heads)                        # [B,1,KV,G,Dh]
    scale = spec.query_scale or spec.head_dim ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg,
                          cache["k"].to(x.dtype)).float() * scale
    if spec.attn_softcap:
        scores = softcap(scores, spec.attn_softcap)
    kpos = torch.arange(Smax, dtype=torch.int32, device=x.device)
    ok = kpos <= pos
    if spec.sliding_window:
        ok &= kpos > pos - spec.sliding_window
    scores = torch.where(ok, scores, torch.tensor(
        NEG_INF, dtype=torch.float32, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", probs, cache["v"].to(x.dtype))
    ctx = ctx.reshape(B, 1, spec.n_heads, spec.head_dim)
    # decode_tp: heads over "model", head_dim over the data axes — matches
    # wo's stationary layout so the output contraction reduces activations
    ctx = constrain(ctx, "batch", None, "model", "tpd")
    out = torch.einsum("bqhk,hkd->bqd", ctx, params["wo"].to(x.dtype))
    return out, cache
