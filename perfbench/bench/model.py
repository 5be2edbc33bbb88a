"""The system under test, built from a configuration file: the port's
``ModelConfig`` and weights drawn on the device from the seed.

The weights are the benchmark's inputs, made here and handed unchanged to
the port and to the plain reference.  Each leaf of the port's parameter
tree (``lm.param_specs``: names, shapes, dtypes) is drawn in the dtype it
is served in, on the device, by one call on one ``torch.Generator``
seeded with the run's seed, in the tree's order, by the rule its name
(the last part of its path) finds:

* a rule of the configuration file's ``init.leaves``, keyed by leaf name:
  ``{"std": <number> | "fan_in"}`` (normal; ``fan_in`` is
  ``shape[-2] ** -0.5``) or ``{"const": <number>}``; else
* ``*norm`` and ``D``: 1; ``conv_bias_*``: 0 (no draw);
* ``embed``: normal at ``init.embed_std``;
* the projections into the model's width's products (``wq``, ``wk``,
  ``wv``, ``wo``, ``w_gate``, ``w_up``, ``router``, ``unembed``, and
  Mamba-2's ``in_z``, ``in_x``, ``in_B``, ``in_C``, ``in_dt``): normal at
  ``d_model ** -0.5``;
* ``w_down``, ``out_proj`` and the depthwise filters ``conv_x``,
  ``conv_B``, ``conv_C``: normal at ``shape[-2] ** -0.5`` (the width the
  product sums over, the filter's width W for a filter [W, channels]);
* Mamba-2's published initialisation (arXiv:2405.21060): ``A_log`` the
  log of A uniform in ``init.A_range`` ([1, 16]); ``dt_bias`` the inverse
  softplus, ``dt + log(-expm1(-dt))``, of dt log-uniform in
  [``init.dt_min``, ``init.dt_max``] ([0.001, 0.1]).

A leaf that no rule draws raises, naming the leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

#: Leaves drawn normal at d_model ** -0.5.
BY_D_MODEL = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "router",
                        "unembed", "in_z", "in_x", "in_B", "in_C", "in_dt"})
#: Leaves drawn normal at shape[-2] ** -0.5.
BY_FAN_IN = frozenset({"w_down", "out_proj", "conv_x", "conv_B", "conv_C"})


def program_config(config: Mapping):
    """The port's ``ModelConfig`` for a configuration file's ``model``."""
    from repro_torch.models.config import LayerSpec, ModelConfig
    model = dict(config["model"])
    model["pattern"] = tuple(LayerSpec(m, f) for m, f in model["pattern"])
    return ModelConfig(**model)


def rule(path: str, shape, model: Mapping, init: Mapping
         ) -> Tuple[str, Any]:
    """How the leaf at ``path`` is drawn: ("const", value), ("normal",
    std), ("A_log", (lo, hi)) or ("dt_bias", (dt_min, dt_max))."""
    leaf = path.rsplit(".", 1)[-1]
    given = init.get("leaves", {}).get(leaf)
    if given is not None:
        if "const" in given:
            return "const", float(given["const"])
        std = given["std"]
        return "normal", shape[-2] ** -0.5 if std == "fan_in" else float(std)
    if leaf.endswith("norm") or leaf == "D":
        return "const", 1.0
    if leaf.startswith("conv_bias_"):
        return "const", 0.0
    if leaf == "embed":
        return "normal", init["embed_std"]
    if leaf in BY_D_MODEL:
        return "normal", model["d_model"] ** -0.5
    if leaf in BY_FAN_IN:
        return "normal", shape[-2] ** -0.5
    if leaf == "A_log":
        return "A_log", tuple(init.get("A_range", (1.0, 16.0)))
    if leaf == "dt_bias":
        return "dt_bias", (init.get("dt_min", 0.001),
                           init.get("dt_max", 0.1))
    raise KeyError(f"no rule draws the weight {path}: add one for "
                   f"{leaf!r} to the configuration file's init.leaves")


def draw_weights(cfg, config: Mapping, seed: int, device) -> Dict[str, Any]:
    """The port's parameter tree for ``cfg``, drawn from ``seed`` on
    ``device`` leaf by leaf in each leaf's dtype (a grok expert stack, 9.7e9
    elements, a group at a time); ``config`` is the configuration file."""
    from repro_torch.models.lm import param_specs
    gen = torch.Generator(device=device).manual_seed(seed)
    model, init = config["model"], config.get("init", {})

    def draw(node, path):
        if isinstance(node, dict):
            return {k: draw(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        kind, arg = rule(path, node.shape, model, init)
        if kind == "const":
            return torch.full(node.shape, arg, dtype=node.dtype,
                              device=device)
        out = torch.empty(node.shape, dtype=node.dtype, device=device)
        # one call a leaf, or a group where a leaf passes 2**31 elements
        for part in (out.unbind(0) if out.numel() >= 2 ** 31 else (out,)):
            if kind == "normal":
                part.normal_(generator=gen).mul_(arg)
            elif kind == "A_log":
                part.uniform_(*arg, generator=gen).log_()
            else:                           # dt_bias
                lo, hi = map(math.log, arg)
                dt = part.uniform_(lo, hi, generator=gen).exp_()
                dt.add_(torch.log(-torch.expm1(-dt)))
        return out

    return draw(param_specs(cfg), "")


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
