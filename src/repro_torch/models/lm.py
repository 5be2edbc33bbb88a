"""Language-model assembly: embedding → block groups → head.

Parameters are nested dicts with the JAX package's names; per-group block
parameters are *stacked* along a leading ``n_groups`` axis, as the JAX
package's ``init_params`` builds them.  Where the JAX package runs
``lax.scan`` over the stack, the port loops over the groups in Python and
indexes ``[g]`` of each stacked tensor.  Heterogeneous patterns (gemma-2's
local/global alternation) are unrolled inside each group.

Three entry points per config:
  * ``forward(params, batch, cfg)``          — logits for training/prefill
  * ``loss_fn(params, batch, cfg)``          — mean CE + MoE aux losses
  * ``decode_step(params, cache, tok, pos, cfg)`` — one-token serve step

Every mixer (attention, Mamba-2) and FFN (dense MLP, MoE) of the JAX
package is ported, and so are its activation-sharding constraints
(``sharding_ctx.constrain``, at the same places): they act only on
``DTensor``s under ``activation_sharding`` (the dry run) and return their
input itself everywhere else.  ``param_specs`` builds the parameter tree
on the meta device, for the dry run's partition rules and pricing.

Each part runs inside a span of ``runtime/tracing.py`` (off unless
enabled): ``lm.forward`` / ``lm.decode_step`` holding ``lm.embed``, one
``lm.layer`` a layer (its norms and residuals, ``lm.attention`` /
``lm.decode_attention`` or ``lm.mamba``, ``lm.mlp`` or ``lm.moe``) and
``lm.head``.

``cfg.remat`` checkpoints each group when a gradient is recorded, as the
JAX package wraps its scan body in ``jax.checkpoint``: the group's
activations are dropped after the forward and recomputed in the backward
(``remat_policy="dots"`` keeps the matrix products' outputs).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts,
)

from .attention import (
    AttnSpec, attention, decode_attention, init_attn_params, init_kv_cache,
)
from .config import LayerSpec, ModelConfig
from .layers import ACTIVATIONS, cross_entropy, rms_norm, softcap
from .moe import MoESpec, init_moe_params, moe_ffn
from ..runtime.tracing import span
from .sharding_ctx import constrain
from .ssm import (
    SSMSpec, decode_ssm, init_ssm_cache, init_ssm_params, ssm_forward,
)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig, spec: LayerSpec) -> AttnSpec:
    sliding = cfg.sliding_window if spec.mixer in ("attn_local",) else 0
    if spec.mixer == "attn" and cfg.sliding_window and not cfg.has_ssm:
        # archs whose only attention is sliding (none assigned currently)
        sliding = cfg.sliding_window
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, attn_softcap=cfg.attn_softcap,
        sliding_window=sliding, causal=cfg.causal, mrope=cfg.mrope)


def moe_spec(cfg: ModelConfig) -> MoESpec:
    return MoESpec(n_experts=cfg.moe_experts, top_k=cfg.moe_topk,
                   d_ff=cfg.moe_d_ff or cfg.d_ff,
                   capacity_factor=cfg.capacity_factor, act=cfg.act)


def ssm_spec(cfg: ModelConfig) -> SSMSpec:
    return SSMSpec(d_inner=cfg.d_inner, n_heads=cfg.ssm_heads,
                   headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                   conv_width=cfg.ssm_conv_width, chunk=cfg.ssm_chunk)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, *,
              lead: Tuple[int, ...] = (), device=None) -> Dict:
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, s):
        return torch.randn(lead + shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(s).to(dtype)

    return {"w_gate": normal((d, f), d ** -0.5),
            "w_up": normal((d, f), d ** -0.5),
            "w_down": normal((f, d), f ** -0.5)}


def _init_group(gen: torch.Generator, cfg: ModelConfig, *,
                lead: Tuple[int, ...] = (), device=None) -> Dict:
    """Parameters for the pattern applied once, each with the ``lead``
    stacking axes in front."""
    dtype = _dtype(cfg.param_dtype)
    out: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        layer: Dict[str, Any] = {"pre_norm": torch.ones(
            lead + (cfg.d_model,), dtype=dtype, device=device)}
        if spec.mixer.startswith("attn"):
            layer["attn"] = init_attn_params(
                gen, cfg.d_model, attn_spec(cfg, spec), dtype, lead=lead,
                device=device)
        elif spec.mixer == "mamba":
            layer["mamba"] = init_ssm_params(
                gen, cfg.d_model, ssm_spec(cfg), dtype, lead=lead,
                device=device)
        if spec.ffn == "mlp":
            layer["ffn_norm"] = torch.ones(lead + (cfg.d_model,),
                                           dtype=dtype, device=device)
            layer["mlp"] = _init_mlp(gen, cfg, dtype, lead=lead,
                                     device=device)
        elif spec.ffn == "moe":
            layer["ffn_norm"] = torch.ones(lead + (cfg.d_model,),
                                           dtype=dtype, device=device)
            layer["moe"] = init_moe_params(gen, cfg.d_model, moe_spec(cfg),
                                           dtype, lead=lead, device=device)
        out[f"layer{i}"] = layer
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Dict:
    """Random parameters with the JAX package's shapes, scales and dtypes,
    drawn from ``gen`` (whose device must be ``device``).  The numbers
    differ from JAX's for the same seed."""
    device = _device(device)
    dtype = _dtype(cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=device,
            dtype=torch.float32).mul_(0.02).to(dtype)
    params["blocks"] = _init_group(gen, cfg, lead=(cfg.n_groups,),
                                   device=device)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                      device=device)
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        params["unembed"] = torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=device,
            dtype=torch.float32).mul_(cfg.d_model ** -0.5).to(dtype)
    return params


def param_specs(cfg: ModelConfig) -> Dict:
    """The parameter tree on the meta device: ``init_params``'s names,
    shapes and dtypes, with no storage.  A draw on the meta device with no
    generator advances no random stream."""
    return init_params(None, cfg, device="meta")


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device="cuda") -> Dict:
    """The JAX package's parameters (a nested dict of numpy arrays, stacked
    over groups as its ``init_params`` builds them) as the port's: the same
    names, shapes and dtypes, on ``device``."""
    device = _device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(device)

    return convert(tree)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the shapes ``init_params`` builds (no
    allocation).  ``active_only`` scales each stacked MoE expert tensor
    (every ``moe`` leaf but the router) by ``topk / E``, rounding down per
    leaf, as the JAX package does."""
    total = cfg.d_model                                   # final_norm
    if cfg.input_mode == "tokens":
        total += cfg.vocab_size * cfg.d_model
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        total += cfg.d_model * cfg.vocab_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    Din, SH, N, W = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, \
        cfg.ssm_conv_width
    G, E = cfg.n_groups, cfg.moe_experts
    for spec in cfg.pattern:
        per_layer = cfg.d_model                           # pre_norm
        if spec.mixer.startswith("attn"):
            per_layer += cfg.d_model * (2 * H + 2 * KV) * Dh
            if cfg.qk_norm:
                per_layer += 2 * Dh
        elif spec.mixer == "mamba":
            per_layer += (cfg.d_model * (2 * Din + 2 * N + SH)  # in_*
                          + (W + 1) * (Din + 2 * N)            # conv_*
                          + 3 * SH + Din                       # dt, A, D, norm
                          + Din * cfg.d_model)                 # out_proj
        if spec.ffn == "mlp":
            per_layer += cfg.d_model + 3 * cfg.d_model * cfg.d_ff
        elif spec.ffn == "moe":
            per_layer += cfg.d_model + cfg.d_model * E     # ffn_norm, router
            expert = G * E * cfg.d_model * moe_spec(cfg).d_ff  # one leaf
            if active_only:
                expert = int(expert * cfg.moe_topk / E)
            total += 3 * expert                  # w_gate, w_up, w_down
        total += G * per_layer
    return total


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model's device is 'cuda' but there is no "
                           "CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return device


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _mlp(layer: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    h = act(torch.einsum("bsd,df->bsf", x, layer["w_gate"].to(x.dtype)),
            torch.einsum("bsd,df->bsf", x, layer["w_up"].to(x.dtype)))
    # "tp" pins h to the stationary weight layout in decode_tp mode (no-op
    # during training)
    h = constrain(h, "batch", None, "tp")
    return torch.einsum("bsf,fd->bsd", h, layer["w_down"].to(x.dtype))


def _index(tree, g: int):
    """Group ``g`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind(tree, n: int):
    """The ``n`` groups of a stacked parameter tree, as views from one
    ``unbind`` a leaf.  Its gradient is one stack of the groups'
    gradients; indexing each group (``_index``) would add a zero-filled
    stack-sized gradient per group instead."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: p[g] for k, p in parts.items()} for g in range(n)]
    return tree.unbind(0)


def _ffn(cfg: ModelConfig, spec: LayerSpec, layer: Dict, x: torch.Tensor):
    """The layer's FFN with its residual: (x, the MoE's metrics or None)."""
    if spec.ffn == "none":
        return x, None
    h = rms_norm(x, layer["ffn_norm"], zero_centered=cfg.zero_centered_norm)
    if spec.ffn == "mlp":
        with span("lm.mlp"):
            out = _mlp(layer["mlp"], h, cfg)
        return x + out, None
    if spec.ffn == "moe":
        with span("lm.moe"):
            out, metrics = moe_ffn(layer["moe"], h, moe_spec(cfg))
        return x + out, metrics
    raise ValueError(spec.ffn)


def _apply_group(cfg: ModelConfig, group_params: Dict, x: torch.Tensor,
                 positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the pattern once. Returns (x, aux_loss_sum) in fp32."""
    # Re-assert the activation sharding at each group; with seq_shard the
    # remat stash also shards its sequence dim over "model".
    x = constrain(x, "batch", "model" if cfg.seq_shard else None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.pattern):
        with span("lm.layer"):
            layer = group_params[f"layer{i}"]
            h = rms_norm(x, layer["pre_norm"],
                         zero_centered=cfg.zero_centered_norm)
            if spec.mixer.startswith("attn"):
                with span("lm.attention"):
                    mix = attention(layer["attn"], h, attn_spec(cfg, spec),
                                    positions=positions)
            elif spec.mixer == "mamba":
                with span("lm.mamba"):
                    mix = ssm_forward(layer["mamba"], h, ssm_spec(cfg))
            else:
                raise ValueError(spec.mixer)
            x, metrics = _ffn(cfg, spec, layer, x + mix)
            if metrics is not None:
                aux = aux + metrics["aux_loss"] + metrics["z_loss"]
    return x, aux


def _embed(params: Dict, inputs: torch.Tensor, cfg: ModelConfig,
           compute: torch.dtype) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        # F.embedding's backward sums the rows of repeated tokens in one
        # fixed order on the card: resumed training is bitwise the
        # uninterrupted run's (chip_smoke.py's train_parity)
        x = F.embedding(inputs.long(), params["embed"]).to(compute)
    else:
        x = inputs.to(compute)
    if cfg.embed_scale:
        # the scale rounds to the compute dtype first (bf16: 59.87 -> 59.75)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute,
                             device=x.device)
    return x


def _head(params: Dict, x: torch.Tensor, cfg: ModelConfig,
          logical=None) -> torch.Tensor:
    """Final norm, unembedding and softcap; ``logical`` constrains the
    logits before their fp32 cast (training and prefill)."""
    x = rms_norm(x, params["final_norm"], zero_centered=cfg.zero_centered_norm)
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["unembed"].to(x.dtype))
    if logical is not None:
        logits = constrain(logits, *logical)
    logits = logits.float()          # rebinding frees the compute-dtype copy
    return softcap(logits, cfg.final_softcap)


#: What ``remat_policy="dots"`` saves: the outputs of the matrix products.
#: The JAX package saves its dots without batch dimensions; the port's
#: einsums lower to mm and bmm, and both are saved.
_SAVED_BY_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default]


def forward(params: Dict, batch: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V] fp32, aux_loss scalar).

    batch: {"tokens": [B,S] int} or {"embeddings": [B,S,d]};
    optional {"positions": [B,S] or [3,B,S] for mrope}.
    """
    with span("lm.forward"):
        compute = _dtype(cfg.compute_dtype)
        inputs = batch["tokens"] if cfg.input_mode == "tokens" \
            else batch["embeddings"]
        with span("lm.embed"):
            x = _embed(params, inputs, cfg, compute)
        x = constrain(x, "batch", "model" if cfg.seq_shard else None, None)
        positions = batch.get("positions")
        body = partial(_apply_group, cfg)
        if cfg.remat and torch.is_grad_enabled():
            kw = dict(use_reentrant=False)
            if cfg.remat_policy == "dots":
                kw["context_fn"] = partial(
                    create_selective_checkpoint_contexts, _SAVED_BY_DOTS)
            body = partial(checkpoint, body, **kw)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group in _unbind(params["blocks"], cfg.n_groups):
            x, aux_g = body(group, x, positions)
            aux = aux + aux_g
        logical = (("batch", "model", None) if cfg.seq_shard
                   else ("batch", None, "model"))
        with span("lm.head"):
            logits = _head(params, x, cfg, logical)
    return logits, aux


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(params, batch, cfg)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode with caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict:
    """Nested cache: one stacked entry per layer kind per group, in the
    compute dtype (attention: k/v; mamba: conv windows and SSD state)."""
    device = _device(device)
    dtype = _dtype(cfg.compute_dtype)
    lead = (cfg.n_groups,)
    cache: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer.startswith("attn"):
            cache[f"layer{i}"] = init_kv_cache(
                batch, max_len, attn_spec(cfg, spec), dtype, lead=lead,
                device=device)
        elif spec.mixer == "mamba":
            cache[f"layer{i}"] = init_ssm_cache(
                batch, ssm_spec(cfg), dtype, lead=lead, device=device)
    return cache


def _decode_group(cfg: ModelConfig, group_params: Dict, group_cache: Dict,
                  x: torch.Tensor, pos: int) -> torch.Tensor:
    for i, spec in enumerate(cfg.pattern):
        with span("lm.layer"):
            layer = group_params[f"layer{i}"]
            h = rms_norm(x, layer["pre_norm"],
                         zero_centered=cfg.zero_centered_norm)
            if spec.mixer.startswith("attn"):
                with span("lm.decode_attention"):
                    mix, _ = decode_attention(layer["attn"], h,
                                              group_cache[f"layer{i}"], pos,
                                              attn_spec(cfg, spec))
            else:
                with span("lm.mamba"):
                    mix, _ = decode_ssm(layer["mamba"], h,
                                        group_cache[f"layer{i}"],
                                        ssm_spec(cfg))
            x, _ = _ffn(cfg, spec, layer, x + mix)   # MoE: G = B, C = 8
    return x


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One serve step. tokens [B] int (or embeddings [B,d]); pos int.
    Returns (logits [B,V] fp32, cache): the cache is updated in place (see
    ``attention.decode_attention`` and ``ssm.decode_ssm``) and returned."""
    with span("lm.decode_step"):
        compute = _dtype(cfg.compute_dtype)
        inputs = tokens if cfg.input_mode == "tokens" else tokens[:, None, :]
        with span("lm.embed"):
            x = _embed(params, inputs, cfg, compute)
        if cfg.input_mode == "tokens":
            x = x[:, None, :]
        x = constrain(x, "batch", None, None)
        for g in range(cfg.n_groups):
            x = constrain(x, "batch", None, None)
            x = _decode_group(cfg, _index(params["blocks"], g),
                              _index(cache, g), x, pos)
        with span("lm.head"):
            logits = _head(params, x, cfg)[:, 0]
    return logits, cache
