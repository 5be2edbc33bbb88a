"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B.

48L, d_model 2048, 32H (GQA kv=4, head_dim 128), vocab 151936.
MoE 128 experts top-8, expert d_ff 768, QK-RMSNorm, untied embeddings.
~30B total, ~3B active per token.
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    pattern=(LayerSpec("attn", "moe"),),
    moe_experts=128,
    moe_topk=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)
