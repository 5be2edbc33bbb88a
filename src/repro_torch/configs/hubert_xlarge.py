"""hubert-xlarge [audio] — arXiv:2106.07447 (config unverified tier).

48L encoder-only transformer backbone, d_model 1280, 16H (kv=16), d_ff
5120, 504 output classes (masked-unit prediction).  The conv waveform
frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings [B, S, d_model].  Bidirectional attention
(causal=False) — no decode step, so decode_32k/long_500k are skipped
(DESIGN.md §5).  RoPE stands in for HuBERT's conv positional embedding
(hardware-adaptation note in DESIGN.md §8).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pattern=(LayerSpec("attn", "mlp"),),
    causal=False,
    input_mode="embeddings",
    tie_embeddings=False,
    act="geglu",
)
