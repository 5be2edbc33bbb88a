"""gemma-2b [dense] — arXiv:2403.08295.

18L, d_model 2048, 8H (MQA kv=1, head_dim 256), d_ff 16384, vocab 256000.
GeGLU, scaled embeddings, zero-centered RMSNorm, tied embeddings.
8 heads are 16-indivisible → TP shards head_dim (256/16 = 16).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    pattern=(LayerSpec("attn", "mlp"),),
    act="geglu",
    embed_scale=True,
    zero_centered_norm=True,
    tie_embeddings=True,
)
