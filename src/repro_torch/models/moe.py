"""Mixture-of-experts FFN: top-k routing with capacity-bounded dispatch.

The JAX package's GShard/Mesh-TF dense formulation in plain torch (the
JAX package writes no kernel for it): token→expert assignment becomes
one-hot dispatch and combine tensors [G,S,E,C] contracted with einsums.

The capacity assignment runs *per top-k slot*: slot k's positions
continue the per-expert occupancy left by slots < k, so which token a
full expert drops is the JAX package's.  Experts are chosen as
``lax.top_k`` chooses them, the lower index first among equal
probabilities (a stable descending sort; ``torch.topk`` promises no order
for ties).

Aux losses: load-balancing (Switch Transformer) + router z-loss (ST-MoE).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import ACTIVATIONS

__all__ = ["MoESpec", "capacity", "init_moe_params", "route", "assign",
           "experts", "moe_ffn"]


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    act: str = "swiglu"
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


def init_moe_params(gen: torch.Generator, d_model: int, spec: MoESpec,
                    dtype, *, lead: Tuple[int, ...] = (),
                    device=None) -> Dict:
    """The JAX package's names, shapes, scales and dtypes (the router
    stays fp32); ``lead`` prepends stacking axes (the groups of
    ``lm.init_params``).  Each tensor is drawn in fp32 one leading index at
    a time into a tensor of its final dtype, so the fp32 draw never holds
    more than one group's experts (qwen3-moe-30b-a3b: 0.8 GB, not the
    38.7 GB of a whole stacked tensor)."""
    E, F_ = spec.n_experts, spec.d_ff

    def normal(shape, s, dt=dtype):
        out = torch.empty(lead + shape, dtype=dt, device=device)
        for idx in itertools.product(*map(range, lead)):
            out[idx] = torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float32).mul_(s)
        return out

    s_in, s_out = d_model ** -0.5, F_ ** -0.5
    return {
        "router": normal((d_model, E), s_in, torch.float32),
        "w_gate": normal((E, d_model, F_), s_in),
        "w_up": normal((E, d_model, F_), s_in),
        "w_down": normal((E, F_, d_model), s_out),
    }


def capacity(tokens_per_group: int, spec: MoESpec) -> int:
    cap = int(tokens_per_group * spec.top_k * spec.capacity_factor
              / spec.n_experts)
    # hardware-aligned and never zero
    return max(8, -(-cap // 8) * 8)


def route(params: Dict, x: torch.Tensor, spec: MoESpec):
    """Router of ``x`` [G,S,d]: fp32 logits and probabilities [G,S,E], the
    renormalised gates [G,S,K] and the chosen experts [G,S,K] (int64),
    each token's most probable first, the lower index first on ties."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals = gate_vals[..., :spec.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    return logits, probs, gate_vals, expert_idx[..., :spec.top_k]


def assign(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
           n_experts: int, C: int, dtype):
    """Capacity assignment (Mesh-TF): slot k's positions continue the
    per-expert occupancy left by slots < k, and an expert keeps its first
    C.  Returns the one-hot dispatch and the gated combine tensors
    [G,S,E,C] in ``dtype`` and the count of kept (token, slot) pairs.

    The JAX package loops over the K slots, each a cumulative sum over the
    group of a one-hot [G,S,E].  Its position for (s, k) is the number of
    earlier (token, slot) pairs naming the same expert in slot-major
    order, which one stable sort by expert of the K*S slot-major choices
    gives for every slot at once."""
    G, S, K = expert_idx.shape
    dev = expert_idx.device
    flat = expert_idx.transpose(1, 2).reshape(G, K * S)        # slot-major
    order = torch.argsort(flat, dim=1, stable=True)
    counts = F.one_hot(flat, n_experts).sum(dim=1)             # [G,E]
    first = torch.cumsum(counts, dim=1) - counts               # group starts
    rank = torch.arange(K * S, device=dev) - first.gather(
        1, flat.gather(1, order))                              # in the group
    pos = torch.empty_like(rank).scatter_(1, order, rank).view(
        G, K, S).transpose(1, 2)                               # [G,S,K]
    within = pos < C
    dispatch = torch.zeros((G, S, n_experts, C), dtype=dtype, device=dev)
    combine = torch.zeros_like(dispatch)
    # a token names an expert at most once, so no two (s, k) share a cell
    slot = (torch.arange(G, device=dev)[:, None, None],
            torch.arange(S, device=dev)[None, :, None],
            expert_idx, pos.clamp(max=C - 1))
    dispatch[slot] = within.to(dtype)
    combine[slot] = gate_vals.to(dtype) * within.to(dtype)
    return dispatch, combine, within.sum()


def experts(params: Dict, expert_in: torch.Tensor, spec: MoESpec
            ) -> torch.Tensor:
    """The experts' FFNs on their slots [E,G,C,d], weights cast to the
    activations' dtype."""
    act = ACTIVATIONS[spec.act]
    dtype = expert_in.dtype
    h = act(torch.einsum("egcd,edf->egcf", expert_in,
                         params["w_gate"].to(dtype)),
            torch.einsum("egcd,edf->egcf", expert_in,
                         params["w_up"].to(dtype)))
    return torch.einsum("egcf,efd->egcd", h, params["w_down"].to(dtype))


def moe_ffn(params: Dict, x: torch.Tensor, spec: MoESpec
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] — groups are batch rows (G=B, group size S).

    Returns (output [B,S,d], aux metrics {aux_loss, z_loss,
    fraction_dropped}), fp32 scalars."""
    G, S, d = x.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(S, spec)
    logits, probs, gate_vals, expert_idx = route(params, x, spec)
    dispatch, combine, kept = assign(expert_idx, gate_vals, E, C, x.dtype)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x)       # [E,G,C,d]
    expert_out = experts(params, expert_in, spec)                 # [E,G,C,d]
    # "gsec,egcd->gsd" as one batched product over (e, c) in the order the
    # tensors lie: torch.einsum would first copy both operands into (c, e)
    # order
    out = combine.view(G, S, E * C) @ expert_out.transpose(0, 1).reshape(
        G, E * C, d)                                              # [G,S,d]

    # -- aux losses -----------------------------------------------------------
    # load balance: E * sum_e (fraction_tokens_e * mean_prob_e)
    top1 = F.one_hot(expert_idx[..., 0], E).float()
    frac_tokens = top1.mean(dim=(0, 1))                           # [E]
    mean_prob = probs.mean(dim=(0, 1))                            # [E]
    aux_loss = E * torch.sum(frac_tokens * mean_prob)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    # a tensor divisor: torch divides a CUDA tensor by a Python scalar as a
    # product with its reciprocal, one rounding off the exact quotient
    dropped = 1.0 - kept.float() / torch.full((), float(G * S * K),
                                              device=x.device)
    metrics = {
        "aux_loss": aux_loss * spec.aux_loss_weight,
        "z_loss": z_loss * spec.z_loss_weight,
        "fraction_dropped": dropped,
    }
    return out, metrics
