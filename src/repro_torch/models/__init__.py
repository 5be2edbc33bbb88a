"""Model zoo: the JAX package's transformer, Mamba-2 and MoE stacks in
plain torch, with prefill attention through the flash-attention kernel and
the SSD scan through the ssd_scan kernel (the MoE FFN, like the JAX
package's, has no kernel of its own)."""
from .attention import AttnSpec, attention, decode_attention, init_kv_cache
from .config import LayerSpec, ModelConfig
from .layers import cross_entropy, rms_norm, softcap
from .lm import (
    count_params, decode_step, forward, init_cache, init_params, loss_fn,
    param_specs, params_from_numpy,
)
from .moe import MoESpec, moe_ffn
from .ssm import SSMSpec, ssd_chunked, ssm_forward

__all__ = [
    "ModelConfig", "LayerSpec", "AttnSpec", "MoESpec", "SSMSpec",
    "forward", "loss_fn", "decode_step", "init_params", "init_cache",
    "param_specs", "params_from_numpy", "count_params",
    "attention", "decode_attention", "init_kv_cache",
    "moe_ffn", "ssm_forward", "ssd_chunked",
    "rms_norm", "softcap", "cross_entropy",
]
