"""Model zoo: the JAX package's transformer and Mamba-2 stacks in plain
torch, with prefill attention through the flash-attention kernel and the
SSD scan through the ssd_scan kernel.  The MoE FFN is not ported yet
(ROADMAP Queue 1 item 6)."""
from .attention import AttnSpec, attention, decode_attention, init_kv_cache
from .config import LayerSpec, ModelConfig
from .layers import cross_entropy, rms_norm, softcap
from .lm import (
    count_params, decode_step, forward, init_cache, init_params, loss_fn,
    params_from_numpy,
)
from .ssm import SSMSpec, ssd_chunked, ssm_forward

__all__ = [
    "ModelConfig", "LayerSpec", "AttnSpec", "SSMSpec",
    "forward", "loss_fn", "decode_step", "init_params", "init_cache",
    "params_from_numpy", "count_params",
    "attention", "decode_attention", "init_kv_cache",
    "ssm_forward", "ssd_chunked",
    "rms_norm", "softcap", "cross_entropy",
]
