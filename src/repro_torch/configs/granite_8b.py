"""granite-8b [dense] — arXiv:2405.04324 (Granite Code).

36L, d_model 4096, 32H (GQA kv=8), d_ff 14336, vocab 49152. Llama-style
pre-norm decoder, SwiGLU, tied embeddings.
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=10000000.0,
    tie_embeddings=True,
)
