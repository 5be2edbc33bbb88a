"""qwen3-14b [dense] — hf:Qwen/Qwen3-14B.

40L, d_model 5120, 40H (GQA kv=8, head_dim 128), d_ff 17408, vocab 151936.
Per-head QK-RMSNorm, untied embeddings.  40 heads are 16-indivisible, so
tensor parallelism shards head_dim (interleaved-RoPE keeps pairs local —
DESIGN.md §6).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    pattern=(LayerSpec("attn", "mlp"),),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)
