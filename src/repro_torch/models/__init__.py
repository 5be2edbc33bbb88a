"""Model zoo, dense path: the JAX package's transformer stack in plain
torch, with prefill attention through the flash-attention kernel.  The MoE
and SSM mixers are not ported yet (ROADMAP Queue 1 item 6)."""
from .attention import AttnSpec, attention, decode_attention, init_kv_cache
from .config import LayerSpec, ModelConfig
from .layers import cross_entropy, rms_norm, softcap
from .lm import (
    count_params, decode_step, forward, init_cache, init_params, loss_fn,
    params_from_numpy,
)

__all__ = [
    "ModelConfig", "LayerSpec", "AttnSpec",
    "forward", "loss_fn", "decode_step", "init_params", "init_cache",
    "params_from_numpy", "count_params",
    "attention", "decode_attention", "init_kv_cache",
    "rms_norm", "softcap", "cross_entropy",
]
