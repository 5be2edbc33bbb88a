"""mamba2-780m [ssm] — arXiv:2405.21060 (SSD; config unverified tier).

48L attention-free, d_model 1536, d_inner 3072 (expand 2), 48 SSD heads of
headdim 64, d_state 128, vocab 50280.  Pure Mamba-2 blocks (norm → SSD →
residual; no separate FFN).  Decode state is O(1) per layer → runs
long_500k.  Vocab 50280 is 16-indivisible → embeddings replicate
(77M — negligible).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec("mamba", "none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    seq_shard=False,   # SSD chunk scan must not cross sequence shards
)
