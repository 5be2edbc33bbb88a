"""Step functions (train / prefill / decode) + meta-tensor input specs.

``input_specs(cfg, shape)`` builds a stand-in on the meta device for every
model input (the JAX package's ShapeDtypeStructs): the right shapes and
dtypes, no storage.  The dry run distributes these over a mesh and runs
the steps on them without allocating a byte.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import ShapeSpec
from ..models import ModelConfig, decode_step, init_cache, loss_fn
from ..models.lm import forward, param_specs
from ..optim import AdamWConfig, adamw_update, init_opt_state
from ..optim.adamw import tree_leaves, tree_unflatten


# ---------------------------------------------------------------------------
# Input specs (meta tensors — no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
    else:
        batch = {"embeddings": _meta((B, S, cfg.d_model), torch.bfloat16),
                 "labels": _meta((B, S), torch.int32)}
        if cfg.mrope:
            batch["positions"] = _meta((3, B, S), torch.int32)
    return batch


def param_state_specs(cfg: ModelConfig, opt_cfg: AdamWConfig
                      ) -> Tuple[Any, Any]:
    p_specs = param_specs(cfg)
    return p_specs, init_opt_state(p_specs, opt_cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    return init_cache(cfg, batch, max_len, device="meta")


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The decode step's inputs.  ``pos`` is a Python int, as the port's
    ``decode_step`` takes it: the last slot of the cache (the step attends
    over the whole cache under a mask, so its cost does not depend on it)."""
    B = shape.global_batch
    if cfg.input_mode == "tokens":
        tok = _meta((B,), torch.int32)
    else:
        tok = _meta((B, cfg.d_model), torch.bfloat16)
    return {
        "cache": cache_specs(cfg, B, shape.seq_len),
        "tokens": tok,
        "pos": shape.seq_len - 1,
    }


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """All inputs for the shape's step kind, keyed by argument name."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape)}
    return decode_input_specs(cfg, shape)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the loss
    and its gradient w.r.t. every parameter, then one AdamW update.  The
    parameters and moments are updated in place (``adamw_update``) and
    returned; the gradient is taken through aliases of the parameters, so
    their ``requires_grad`` flags are left as they were."""
    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch,
                                    cfg)
            grads = torch.autograd.grad(loss, leaves)
        del leaves
        grads = tree_unflatten(params, grads)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return params, opt_state, out
    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward(params, batch, cfg)
        return logits
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cache, tokens, pos, cfg)
    return serve_step
