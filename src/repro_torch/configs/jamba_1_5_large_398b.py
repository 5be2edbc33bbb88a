"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 / 2408.12570.

72L, d_model 8192, 64H (GQA kv=8), d_ff 24576, vocab 65536, MoE 16e top-2.
Mamba:attention 1:7 interleave (one attention layer per 8-layer Jamba
block, at index 4 as in the paper), MoE every other layer.
Runs long_500k: the attention minority + O(1) SSM state keep decode
sub-quadratic in context (DESIGN.md §5).
"""
from ..models.config import LayerSpec, ModelConfig

_PATTERN = tuple(
    LayerSpec("attn" if i == 4 else "mamba",
              "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    moe_experts=16,
    moe_topk=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    act="swiglu",
    seq_shard=False,   # SSD chunk scan must not cross sequence shards
)
