"""AdamW + global-norm clipping + LR schedules, as the JAX package's
``optim/adamw.py`` computes them, on trees that are nested dicts of
tensors.

State layout mirrors the param tree: {"m": tree, "v": tree, "step": int32
scalar}, plus {"master": tree} of fp32 copies with ``master_weights``.
Moment dtype is configurable (fp32 default; bf16 halves optimizer memory).

Differences from the JAX package, none of them in the numbers:
  * leaves are visited in ``tree_leaves`` order, the order of
    ``jax.tree.leaves`` (dict keys sorted as strings, so ``layer10`` comes
    before ``layer2``), so the global norm sums its squares in the same
    order;
  * ``adamw_update`` writes the new parameters, moments and master weights
    into the tensors it is given (under ``torch.no_grad``) and returns the
    same dicts: a functional update would hold two copies of every leaf at
    once, 30 GB more for gemma-2b's fp32 state.  The step counter is a new
    tensor.
  * the step, the learning rate, ``b1 ** step`` and the bias corrections
    are fp32 tensors on the parameters' device, as the reference's weakly
    typed Python floats against an int32 step are fp32 arrays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    master_weights: bool = False      # keep an fp32 master copy in the
                                      # optimizer; lets params live in bf16
                                      # without update drift
    schedule: str = "cosine"          # constant|cosine|linear
    warmup_steps: int = 100
    total_steps: int = 10000


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: Iterable) -> Any:
    """A tree shaped as ``like`` whose leaves, in ``tree_leaves`` order, are
    the items of ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a scalar tensor), fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), step.device),
                         _f32(1.0, step.device))
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = _f32(1.0, step.device)
    else:
        frac = torch.clip((step - _f32(cfg.warmup_steps, step.device))
                          / _f32(span, step.device), 0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(_f32(math.pi, step.device)
                                           * frac))
    return _f32(cfg.lr, step.device) * warm * decay


def init_opt_state(params: Any, cfg: AdamWConfig) -> Dict:
    mdt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    state = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, summed leaf by leaf in
    ``tree_leaves`` order, fp32."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(_f32(1.0, norm.device),
                         _f32(max_norm, norm.device)
                         / torch.maximum(norm, _f32(1e-9, norm.device)))


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _clip(g, scale), tree), norm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict, Dict]:
    """Returns (params, state, metrics): ``params`` and the moments (and
    master weights) updated in place, ``state["step"]`` advanced.  Each
    gradient leaf is clipped as ``clip_by_global_norm`` clips it, one leaf
    at a time."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip else None
    step = state["step"] + 1
    dev = step.device
    stepf = step.to(torch.float32)
    lr = schedule_lr(cfg, step)
    b1c = 1.0 - _f32(cfg.b1, dev) ** stepf
    b2c = 1.0 - _f32(cfg.b2, dev) ** stepf
    mdt = getattr(torch, cfg.moment_dtype)

    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    flat_w = (tree_leaves(state["master"]) if cfg.master_weights
              else [None] * len(flat_p))
    for p, g, m, v, w in zip(flat_p, flat_g, flat_m, flat_v, flat_w):
        g32 = (_clip(g, scale) if scale is not None else g).to(torch.float32)
        m32 = m.to(torch.float32) * cfg.b1 + g32 * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + torch.square(g32) * (1 - cfg.b2)
        del g32
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
        mhat = m32.div_(b1c)
        vhat = v32.div_(b2c)
        ref = w if w is not None else p.to(torch.float32)
        delta = mhat.div_(vhat.sqrt_().add_(cfg.eps)) \
            + cfg.weight_decay * ref
        del vhat
        new_master = ref - lr * delta
        del delta
        p.copy_(new_master.to(p.dtype))
        if w is not None:
            w.copy_(new_master)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
