"""Model configuration covering all assigned architecture families.

A model is a stack of ``n_layers`` transformer-ish blocks described by a
repeating ``pattern`` of ``LayerSpec``s (mixer + ffn).  Parameters are
stacked over ``n_layers // len(pattern)`` *groups*; the forward pass loops
over the groups with the pattern unrolled inside each.

There is no ``use_pallas`` flag: attention always calls the flash kernel's
front end, which runs the CUDA kernel for tensors on the card and its
plain torch version for tensors on the CPU.  Of the execution fields,
``remat`` and ``remat_policy`` shape training (``lm.forward`` checkpoints
each group while a gradient is recorded); ``attn_chunk``, ``scan_unroll``
and ``seq_shard`` are kept so the configurations stay the JAX package's,
and nothing reads them.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "attn_local" | "attn_global" | "mamba"
    ffn: str              # "mlp" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)

    # attention details
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    causal: bool = True
    mrope: bool = False
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    zero_centered_norm: bool = False # gemma (1+scale) RMSNorm
    act: str = "swiglu"

    # input modality: "tokens" (LM) or "embeddings" (stubbed frontend)
    input_mode: str = "tokens"

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # execution
    remat: bool = True               # checkpoint each scan group in training
    remat_policy: str = "nothing"    # "nothing": recompute all (min memory)
                                     # "dots": save matmul outputs, skip
                                     # their recompute (+weight re-gathers)
    attn_chunk: int = 1024           # KV-chunked online-softmax attention;
                                     # 0 = naive S² materialization
    scan_unroll: bool = False        # unroll the group scan (cost analysis)
    seq_shard: bool = True           # Megatron-style sequence parallelism:
                                     # activations (and the remat stash)
                                     # shard their seq dim over "model".
                                     # Off for SSM/hybrid (the SSD chunk
                                     # scan would serialize across shards).

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def has_attention(self) -> bool:
        return any(s.mixer.startswith("attn") for s in self.pattern)

    @property
    def has_ssm(self) -> bool:
        return any(s.mixer == "mamba" for s in self.pattern)

    @property
    def is_decoder(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Total parameters (exact, by construction rules below)."""
        from .lm import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of E experts)."""
        from .lm import count_params
        return count_params(self, active_only=True)

    def smoke(self) -> "ModelConfig":
        """A reduced config of the same family for CPU smoke tests."""
        pat = self.pattern
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * len(pat) if len(pat) <= 4 else len(pat),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_topk=min(self.moe_topk, 2) if self.moe_topk else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            remat=False,
        )
