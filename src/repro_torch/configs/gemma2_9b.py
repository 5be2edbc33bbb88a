"""gemma2-9b [dense] — arXiv:2408.00118.

42L, d_model 3584, 16H (GQA kv=8, head_dim 256), d_ff 14336, vocab 256000.
Local(4096-window)/global alternating attention, attention-logit softcap 50,
final-logit softcap 30, GeGLU, scaled embeddings, zero-centered RMSNorm.
Skips long_500k (global layers are full attention — DESIGN.md §5).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    pattern=(LayerSpec("attn_local", "mlp"), LayerSpec("attn_global", "mlp")),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="geglu",
    embed_scale=True,
    zero_centered_norm=True,
    tie_embeddings=True,
)
