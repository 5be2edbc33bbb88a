"""grok-1-314b [moe] — hf:xai-org/grok-1 (config unverified).

64L, d_model 6144, 48H (GQA kv=8, head_dim 128), d_ff 32768, vocab 131072.
MoE 8 experts top-2 on every layer.  8 experts are 16-indivisible → expert
weights replicate across the expert-parallel axis and each expert's d_ff
shards over "model" (DESIGN.md §6).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerSpec("attn", "moe"),),
    moe_experts=8,
    moe_topk=2,
    moe_d_ff=32768,
    tie_embeddings=True,
)
