"""Step functions of the serving path: prefill and decode.

``make_train_step`` waits for the training slice (ROADMAP Queue 1 item 7);
the JAX package's ShapeDtypeStruct input specs belong to its dry run
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import torch

from ..models import ModelConfig, decode_step
from ..models.lm import forward


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
