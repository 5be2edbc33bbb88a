"""The system under test, built from a configuration file: the port's
``ModelConfig`` and weights drawn on the device from the seed.

The weights are the benchmark's inputs, made here and handed unchanged to
the port and to the plain reference.  Each leaf of the port's parameter
tree (``lm.param_specs``: names, shapes, dtypes) is drawn by one
``torch.randn`` call in the dtype it is served in, on the device, from one
``torch.Generator`` seeded with the run's seed: normal, scaled by its
fan-in (``d_model ** -0.5`` for every projection into the model's width's
products, ``d_ff ** -0.5`` for the down projections, the configuration's
``init.embed_std`` for the embedding), norms set to 1.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def program_config(config: Mapping):
    """The port's ``ModelConfig`` for a configuration file's ``model``."""
    from repro_torch.models.config import LayerSpec, ModelConfig
    model = dict(config["model"])
    model["pattern"] = tuple(LayerSpec(m, f) for m, f in model["pattern"])
    return ModelConfig(**model)


def _scale(path: str, shape, model: Mapping) -> float:
    leaf = path.rsplit(".", 1)[-1]
    if leaf.endswith("norm"):
        return 0.0
    if leaf == "embed":
        return model["embed_std"]
    if leaf == "w_down":
        return shape[-2] ** -0.5
    if leaf in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "router",
                "unembed"):
        return model["d_model"] ** -0.5
    raise KeyError(f"no rule draws the weight {path}")


def draw_weights(cfg, config: Mapping, seed: int, device) -> Dict[str, Any]:
    """The port's parameter tree for ``cfg``, drawn from ``seed`` on
    ``device`` leaf by leaf in each leaf's dtype (a grok expert stack, 9.7e9
    elements, a group at a time); ``config`` is the configuration file."""
    from repro_torch.models.lm import param_specs
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(node, path):
        if isinstance(node, dict):
            return {k: draw(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        s = _scale(path, node.shape, dict(config["model"],
                                          **config["init"]))
        if s == 0.0:
            return torch.ones(node.shape, dtype=node.dtype, device=device)
        out = torch.empty(node.shape, dtype=node.dtype, device=device)
        # one call a leaf, or a group where a leaf passes 2**31 elements
        for part in (out.unbind(0) if out.numel() >= 2 ** 31 else (out,)):
            part.normal_(generator=gen).mul_(s)
        return out

    return draw(param_specs(cfg), "")


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
