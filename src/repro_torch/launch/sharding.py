"""Partition rules: map every parameter / activation / cache tensor to a
partition spec on the (pod, data, model) production mesh.

Strategy (DESIGN.md §6):
  * batch dims shard over DP axes ("data", plus "pod" when present);
  * weight matrices shard Megatron-style over "model" (column-parallel in,
    row-parallel out) AND over the FSDP axes on the other dim (ZeRO-3-like
    — the weights are gathered per layer where a product needs them);
  * attention shards heads over "model" when the head count divides the
    axis, otherwise head_dim (interleaved RoPE keeps pairs shard-local);
  * MoE shards experts over "model" when E divides it, else each expert's
    d_ff;
  * SSD shards d_inner by whole heads (H % 16 == 0 for assigned archs);
  * every rule degrades to replication when a dim is indivisible — a spec
    is never invalid, only less sharded (and the roofline table shows the
    cost).

A partition spec here is a plain tuple with one entry per tensor dim:
None, an axis name, or a tuple of axis names (the entries of the JAX
package's ``PartitionSpec``).  ``to_placements`` turns one into DTensor
placements on a ``DeviceMesh``.  The rules read only the mesh's axis
sizes, so a ``Sharder`` takes a ``DeviceMesh`` or a plain ``{axis: size}``
mapping.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

from ..models import ModelConfig
from ..models.lm import param_specs
from ..models.sharding_ctx import placements as to_placements
from .mesh import data_axes, mesh_shape

__all__ = ["Sharder", "to_placements"]


def P(*entries) -> Tuple:
    """A partition spec: one entry per tensor dim."""
    return tuple(entries)


def map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict, ``path`` the keys joined by
    "/" (the JAX package's key path of the same leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


class Sharder:
    """``mode="train"`` (default): FSDP(data) × TP(model) — weights gather
    per layer, gradients reduce-scatter; right when every weight is touched
    by thousands of tokens per step.

    ``mode="decode_tp"``: weight-stationary 2-D tensor parallelism — every
    weight shards its *parallel* dim over BOTH mesh axes (data×model = 256
    ways) and never moves; layers finish with activation-sized psums (KB at
    decode batch sizes, vs GB-scale weight gathers).  Right when each
    weight is touched by ONE token per step (§Perf-3).
    """

    def __init__(self, mesh, cfg: ModelConfig, mode: str = "train"):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.cfg = cfg
        self.mode = mode
        self.model_size = self.shape.get("model", 1)
        self.dp_axes = data_axes(mesh)
        self.dp_size = math.prod(self.shape[a] for a in self.dp_axes)
        self.fsdp = tuple(self.dp_axes)   # params' secondary shard axes
        # full-mesh tensor axis set for decode_tp
        self.all_axes = tuple(self.dp_axes) + ("model",)
        self.all_size = self.dp_size * self.model_size

    # -- helpers -------------------------------------------------------------
    def _m(self, dim: int) -> Optional[str]:
        """'model' if dim divides the model axis else None."""
        return "model" if _div(dim, self.model_size) else None

    def _f(self, dim: int):
        """FSDP axes if divisible by the full DP size, else progressively
        fewer axes, else None."""
        if _div(dim, self.dp_size):
            return self.fsdp if len(self.fsdp) > 1 else self.fsdp[0]
        if len(self.fsdp) > 1 and _div(dim, self.shape["data"]):
            return "data"
        return None

    def _b(self, dim: int):
        """Batch sharding over DP axes (requires divisibility)."""
        if _div(dim, self.dp_size):
            return self.fsdp if len(self.fsdp) > 1 else self.fsdp[0]
        if len(self.fsdp) > 1 and _div(dim, self.shape["data"]):
            return "data"
        return None

    def _all(self, dim: int):
        """Full-mesh (data×model) tensor sharding for decode_tp mode."""
        if _div(dim, self.all_size):
            return self.all_axes
        return self._m(dim)

    def _decode_tp_spec(self, path: str, shape: Tuple[int, ...]
                        ) -> Optional[Tuple]:
        """Weight-stationary decode sharding; returns None to fall through
        to the train rules (small/1-D tensors just replicate)."""
        cfg = self.cfg
        blocked = path.startswith("blocks/")

        def with_group(*rest):
            return P(*((None,) + rest)) if blocked else P(*rest)

        name = path.split("/")[-1]
        H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        dp = self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]
        if name == "embed":                     # [V, d]
            return P(self._all(shape[0]), None)
        if name == "unembed":                   # [d, V]
            return P(None, self._all(shape[1]))
        if "attn" in path:
            if name == "wq":                    # [d, H, Dh] -> H×model, Dh×data
                return with_group(None, self._m(H), dp if _div(Dh, self.dp_size) else None)
            if name in ("wk", "wv"):            # [d, KV, Dh]
                kv_m = self._m(KV)
                return with_group(None, kv_m,
                                  dp if _div(Dh, self.dp_size) else None)
            if name == "wo":                    # [H, Dh, d]
                return with_group(self._m(H),
                                  dp if _div(Dh, self.dp_size) else None, None)
        if "mlp" in path or ("moe" in path and name in
                             ("w_gate", "w_up", "w_down")):
            E_sharded = "moe" in path and self._m(cfg.moe_experts)
            if name in ("w_gate", "w_up"):
                # [d, f] or [E, d, f]: f over (data,model) [or data if E×model]
                f_ax = dp if E_sharded else self._all(shape[-1])
                if "moe" in path:
                    return with_group(E_sharded or None, None,
                                      f_ax if _div(shape[-1], self.dp_size) or not E_sharded else None)
                return with_group(None, f_ax)
            if name == "w_down":                # [f, d] or [E, f, d]
                f_ax = dp if E_sharded else self._all(shape[-2])
                if "moe" in path:
                    return with_group(E_sharded or None,
                                      f_ax if _div(shape[-2], self.dp_size) or not E_sharded else None, None)
                return with_group(f_ax, None)
        if "mamba" in path:
            Din = cfg.d_inner
            if name in ("in_z", "in_x"):        # [d, Din]: heads over full mesh
                return with_group(None, self._all(Din))
            if name == "in_dt":
                return with_group(None, self._all(shape[-1]))
            if name == "conv_x":
                return with_group(None, self._all(shape[-1]))
            if name in ("conv_bias_x", "norm"):
                return with_group(self._all(shape[-1]))
            if name in ("dt_bias", "A_log", "D"):
                return with_group(self._all(shape[-1]))
            if name == "out_proj":              # [Din, d]
                return with_group(self._all(Din), None)
        return None

    # -- parameter rules ---------------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Tuple:
        cfg = self.cfg
        if self.mode == "decode_tp":
            spec = self._decode_tp_spec(path, shape)
            if spec is not None:
                return spec
            # fall through: small tensors replicate under train rules minus
            # the fsdp axis (no gathers wanted)
            rank = len(shape)
            return P(*(None,) * rank)
        # strip the leading group-stack dim for block params
        blocked = path.startswith("blocks/")
        dims: Tuple[Optional[Any], ...]

        def with_group(*rest):
            return P(*((None,) + rest)) if blocked else P(*rest)

        name = path.split("/")[-1]
        H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

        if name == "embed":                     # [V, d]
            return P(self._m(shape[0]), self._f(shape[1]))
        if name == "unembed":                   # [d, V]
            return P(self._f(shape[0]), self._m(shape[1]))
        if name == "final_norm":
            return P(None)

        if "attn" in path:
            if name == "wq":                    # [d, H, Dh]
                if self._m(H):
                    return with_group(self._f(cfg.d_model), "model", None)
                return with_group(self._f(cfg.d_model), None, self._m(Dh))
            if name in ("wk", "wv"):            # [d, KV, Dh]
                if self._m(KV):
                    return with_group(self._f(cfg.d_model), "model", None)
                return with_group(self._f(cfg.d_model), None, self._m(Dh))
            if name == "wo":                    # [H, Dh, d]
                if self._m(H):
                    return with_group("model", None, self._f(cfg.d_model))
                return with_group(None, self._m(Dh), self._f(cfg.d_model))
            if name in ("q_norm", "k_norm"):    # [Dh]
                return with_group(None)

        if "mlp" in path:
            if name in ("w_gate", "w_up"):      # [d, f]
                return with_group(self._f(shape[-2]), self._m(shape[-1]))
            if name == "w_down":                # [f, d]
                return with_group(self._m(shape[-2]), self._f(shape[-1]))

        if "moe" in path:
            E = cfg.moe_experts
            if name == "router":                # [d, E]
                return with_group(self._f(shape[-2]), None)
            if name in ("w_gate", "w_up"):      # [E, d, f]
                if self._m(E):
                    return with_group("model", self._f(shape[-2]), None)
                return with_group(None, self._f(shape[-2]), self._m(shape[-1]))
            if name == "w_down":                # [E, f, d]
                if self._m(E):
                    return with_group("model", None, self._f(shape[-1]))
                return with_group(None, self._m(shape[-2]), self._f(shape[-1]))

        if "mamba" in path:
            Din = cfg.d_inner
            if name in ("in_z", "in_x"):        # [d, Din]
                return with_group(self._f(cfg.d_model), self._m(Din))
            if name in ("in_B", "in_C"):        # [d, N]
                return with_group(self._f(cfg.d_model), None)
            if name == "in_dt":                 # [d, H_ssd]
                return with_group(self._f(cfg.d_model), self._m(shape[-1]))
            if name == "conv_x":                # [W, Din]
                return with_group(None, self._m(Din))
            if name in ("conv_B", "conv_C"):
                return with_group(None, None)
            if name == "conv_bias_x" or name == "norm":   # [Din]
                return with_group(self._m(Din))
            if name in ("conv_bias_B", "conv_bias_C"):
                return with_group(None)
            if name in ("dt_bias", "A_log", "D"):         # [H_ssd]
                return with_group(self._m(shape[-1]))
            if name == "out_proj":              # [Din, d]
                return with_group(self._m(Din), self._f(cfg.d_model))

        if name in ("pre_norm", "ffn_norm"):    # [d]
            return with_group(None)

        # fallback: replicate
        rank = len(shape) - (1 if blocked else 0)
        return with_group(*(None,) * rank)

    # -- trees ------------------------------------------------------------------
    def param_pspecs(self) -> Any:
        return map_with_path(lambda path, leaf: self.param_spec(
            path, tuple(leaf.shape)), param_specs(self.cfg))

    def opt_pspecs(self, with_master: bool = False) -> Any:
        """Mirror of param specs for m/v (+ fp32 master) + replicated step."""
        p = self.param_pspecs()
        out = {"m": p, "v": p, "step": P()}
        if with_master:
            out["master"] = p
        return out

    # -- batch / activations ----------------------------------------------------
    def batch_pspecs(self, batch_tree: Any) -> Any:
        def spec(name, leaf):
            if "positions" in name and self.cfg.mrope:   # [3, B, S]
                return P(None, self._b(leaf.shape[1]), None)
            rest = (None,) * (len(leaf.shape) - 1)
            return P(self._b(leaf.shape[0]), *rest)

        return map_with_path(spec, batch_tree)

    # -- decode cache --------------------------------------------------------------
    def cache_pspecs(self, cache_tree: Any) -> Any:
        """Cache leaves: [G, B, S, KV, Dh] (attn k/v), [G, B, W-1, Ch] (conv),
        [G, B, H, P, N] (ssd).  Batch shards over DP; for batch=1 (long_500k)
        the attention sequence dim shards over "model" instead; KV heads or
        head_dim shard over "model" when divisible."""
        cfg = self.cfg

        def spec(name, leaf):
            shape = leaf.shape   # leading G
            b = self._b(shape[1])
            if name.endswith("k") or name.endswith("v"):     # [G,B,S,KV,Dh]
                kv_m = self._m(shape[3])
                dh_m = self._m(shape[4]) if not kv_m else None
                seq_m = None
                if b is None and not kv_m and not dh_m:
                    seq_m = self._m(shape[2])
                elif b is None:
                    # batch=1: shard seq AND heads? only one "model" axis —
                    # prefer the (much larger) sequence dim.
                    seq_m, kv_m, dh_m = self._m(shape[2]), None, None
                return P(None, b, seq_m, kv_m, dh_m)
            if "conv" in name:                               # [G,B,W-1,Ch]
                ch_m = self._m(shape[3]) if "conv_x" in name else None
                return P(None, b, None, ch_m)
            if name.endswith("ssd"):                         # [G,B,H,P,N]
                return P(None, b, self._m(shape[2]), None, None)
            return P(*(None,) * len(shape))

        return map_with_path(spec, cache_tree)

    def logits_pspec(self) -> Tuple:
        batch = self.fsdp if len(self.fsdp) > 1 else self.fsdp[0]
        if self.cfg.seq_shard:
            return P(batch, "model", None)
        return P(batch, None, self._m(self.cfg.vocab_size))
