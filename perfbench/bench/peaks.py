"""The yardstick: the card's peaks and the work a prompt asks for.

Peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit,
dense rates: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of
HBM3.  The operation counts are the model's own, from the configuration's
sizes: the linear layers each token passes through (a MoE layer's router
and its ``top_k`` routed experts, not the capacity's padding) and causal
attention over the pairs its masks keep.
"""
from __future__ import annotations

from typing import Mapping, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def live_pairs(S: int) -> int:
    """(q, k) pairs the causal mask keeps, positions 0..S-1 on both
    sides."""
    return S * (S + 1) // 2


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take in bf16: the larger of
    operations over the peak and bytes over the HBM rate, and which of the
    two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_flops(model: Mapping, S: int) -> int:
    """One attention layer's score and value products over a causal
    sequence of ``S`` tokens: 2 operations a multiply-add, two products."""
    return 4 * model["n_heads"] * model["head_dim"] * live_pairs(S)


def flash_launch(model: Mapping, S: int):
    """(operations, bytes) of one bf16 flash-attention launch over [1, S]:
    q, k, v read once and the output written once."""
    H, KV, D = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    return attention_flops(model, S), (2 * H + 2 * KV) * S * D * 2


def linear_flops_per_token(model: Mapping) -> int:
    """Operations of the linear layers one token passes through: each
    layer's attention projections and its MLP, or its MoE router and the
    ``moe_topk`` experts it is routed to, then the head."""
    d, H, KV, D = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                   model["head_dim"])
    per_kind = {"attn": 2 * d * D * (2 * H + 2 * KV),
                "mlp": 6 * d * model["d_ff"],
                "moe": 2 * d * model.get("moe_experts", 0)
                + model.get("moe_topk", 0) * 6 * d
                * model.get("moe_d_ff", 0),
                "none": 0}
    pattern = model["pattern"]
    groups = model["n_layers"] // len(pattern)
    layer = sum(per_kind[mixer] + per_kind[ffn] for mixer, ffn in pattern)
    return groups * layer + 2 * d * model["vocab_size"]


def attention_layers(model: Mapping) -> int:
    pattern = model["pattern"]
    return (model["n_layers"] // len(pattern)) * sum(
        mixer == "attn" for mixer, _ in pattern)


def prefill_flops(model: Mapping, S: int) -> int:
    """The model operations one causal prompt of ``S`` tokens needs."""
    return (S * linear_flops_per_token(model)
            + attention_layers(model) * attention_flops(model, S))
