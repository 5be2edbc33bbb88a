"""Step functions (train / prefill / decode).

The JAX package's ShapeDtypeStruct input specs belong to its dry run
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import torch

from ..models import ModelConfig, decode_step, loss_fn
from ..models.lm import forward
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import tree_leaves, tree_unflatten


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
