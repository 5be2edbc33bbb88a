"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L decoder backbone, d_model 3584, 28H (GQA kv=4, head_dim 128), d_ff
18944, vocab 152064.  M-RoPE (temporal/height/width position streams over
rotary sections 16/24/24).  The vision tower is a STUB per the assignment:
``input_specs()`` supplies precomputed patch/text embeddings [B, S, d] and
a [3, B, S] position tensor.  28 heads are 16-indivisible → TP shards
head_dim.
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pattern=(LayerSpec("attn", "mlp"),),
    mrope=True,
    rope_theta=1000000.0,
    input_mode="embeddings",
    tie_embeddings=False,
)
