"""The yardstick: the card's peaks and the work a prompt asks for.

Peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit,
dense rates: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of
HBM3.  The operation counts are the model's own, from the configuration's
sizes, layer by layer as the port resolves each layer of the pattern
(``models/lm.py`` ``attn_spec``, ``moe_spec``, ``ssm_spec``):

* attention (``attn``, ``attn_global``, ``attn_local``): the q, k, v and
  output projections, and the score and value products over the (q, k)
  pairs the port's mask keeps: causal or not, within a sliding window of
  ``W`` (``k > q - W``) for ``attn_local``, and for ``attn`` where
  ``sliding_window`` is set and the pattern has no ``mamba`` layer;
* ``mamba`` (Mamba-2, one group): the z, x, B, C, dt and output
  projections, the depthwise causal filter, and the recurrence's own
  operations, state update and read-out, ``4 * d_inner * N`` a token,
  whatever the chunking of the scan that computes it;
* ``mlp``: gate, up and down; ``moe``: the router, the ``moe_topk``
  experts a token is routed to (not the capacity's padding) at
  ``moe_d_ff`` (``d_ff`` where 0), and a shared expert of
  ``moe_shared_d_ff`` where the model states one;
* the head.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Mapping, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def live_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """(q, k) pairs the port's mask keeps over positions 0..S-1 on both
    sides: ``k <= q`` where causal, ``k > q - window`` where windowed."""
    if causal:
        if not window or window >= S:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    cut = max(0, S - window) if window else 0
    return S * S - cut * (cut + 1) // 2


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take in bf16: the larger of
    operations over the peak and bytes over the HBM rate, and which of the
    two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_flops(model: Mapping, S: int, window: int = 0) -> int:
    """One attention layer's score and value products over a sequence of
    ``S`` tokens: 2 operations a multiply-add, two products."""
    return 4 * model["n_heads"] * model["head_dim"] * live_pairs(
        S, window, model.get("causal", True))


def flash_launch(model: Mapping, S: int, window: int = 0):
    """(operations, bytes) of one bf16 flash-attention launch over [1, S]:
    q, k, v read once and the output written once."""
    H, KV, D = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    return attention_flops(model, S, window), (2 * H + 2 * KV) * S * D * 2


def attention_windows(model: Mapping) -> List[int]:
    """The sliding window of each attention layer, 0 for none."""
    pattern = model["pattern"]
    window = model.get("sliding_window", 0)
    hybrid = any(mixer == "mamba" for mixer, _ in pattern)
    per_group = [window if mixer == "attn_local"
                 or (mixer == "attn" and not hybrid) else 0
                 for mixer, _ in pattern if mixer.startswith("attn")]
    return per_group * (model["n_layers"] // len(pattern))


def mamba_flops_per_token(model: Mapping) -> int:
    """One Mamba-2 layer's operations a token: projections, depthwise
    filter, and the recurrence (``4 * d_inner * N``)."""
    d, N, W = model["d_model"], model["ssm_state"], model["ssm_conv_width"]
    Din = model["ssm_expand"] * d
    H = Din // model["ssm_headdim"]
    return (2 * d * (2 * Din + 2 * N + H) + 2 * Din * d
            + 2 * W * (Din + 2 * N) + 4 * Din * N)


def linear_flops_per_token(model: Mapping) -> int:
    """Operations a token costs in every layer but attention's pairs:
    each layer's mixer and its MLP, or its MoE router, the ``moe_topk``
    experts it is routed to and a shared expert, then the head."""
    d, H, KV, D = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                   model["head_dim"])
    attn = 2 * d * D * (2 * H + 2 * KV)
    per_kind = {"attn": attn, "attn_global": attn, "attn_local": attn,
                "mlp": 6 * d * model["d_ff"],
                "moe": 2 * d * model.get("moe_experts", 0)
                + model.get("moe_topk", 0) * 6 * d
                * (model.get("moe_d_ff") or model["d_ff"])
                + 6 * d * model.get("moe_shared_d_ff", 0),
                "none": 0}
    pattern = model["pattern"]
    if any(mixer == "mamba" for mixer, _ in pattern):
        per_kind["mamba"] = mamba_flops_per_token(model)
    groups = model["n_layers"] // len(pattern)
    layer = sum(per_kind[mixer] + per_kind[ffn] for mixer, ffn in pattern)
    return groups * layer + 2 * d * model["vocab_size"]


def prefill_flops(model: Mapping, S: int) -> int:
    """The model operations one prompt of ``S`` tokens needs."""
    return S * linear_flops_per_token(model) + sum(
        n * attention_flops(model, S, window)
        for window, n in Counter(attention_windows(model)).items())
