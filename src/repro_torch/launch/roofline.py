"""Roofline analysis of a counted dry run (no real hardware).

Three terms per (arch × shape × mesh), in seconds:

    compute    = flops      / (chips × peak_FLOP/s)
    memory     = bytes      / (chips × HBM_bw)
    collective = coll_bytes / (chips × link_bw)

The dry run (``launch/dryrun.py``) counts each of them *per device*, on
the shards one rank computes on, so global = per-device × chips.
Collective bytes are the result bytes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute one device receives.
The HLO-text parsers below are the JAX package's, kept so that both
packages read an XLA dump alike; the port's own counts come from its
dispatch counter, not from HLO.

Hardware model (NVIDIA H100 SXM5 80GB, the data sheet's figures):
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and
50 GB/s per link: one 400 Gb/s NDR InfiniBand port per GPU.  NVLink 4
gives 450 GB/s per direction inside an 8-GPU node, but both production
meshes have a 16-wide axis that spans two nodes, so the slowest link on
that axis sets the collective term, as the one ICI constant does in the
JAX package's TPU model.
"""
from __future__ import annotations

import re
from typing import Dict


def cost_analysis_dict(counts) -> Dict[str, float]:
    """The counted run as XLA's ``cost_analysis`` keys: ``{"flops": ...,
    "bytes accessed": ...}`` per device.  ``counts`` is a mapping with
    ``flops`` and ``bytes`` (``dryrun.DeviceCounter.totals()``)."""
    return {"flops": float(counts["flops"]),
            "bytes accessed": float(counts["bytes"])}

PEAK_FLOPS = 989e12     # dense bf16 / H100 SXM5 (data sheet)
HBM_BW = 3.35e12        # bytes/s / H100 SXM5, HBM3 (data sheet)
LINK_BW = 50e9          # bytes/s / link: one 400 Gb/s NDR port per GPU
                        # (NVLink 4 inside a node: 450e9 per direction)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.:  %all-gather.3 = bf16[16,1088,5120]{2,1,0} all-gather(...)
#        ROOT %tuple ... = (f32[2,4]{...}, ...) all-reduce(...)
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[\s(.]")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes_by_kind(hlo_text: str) -> Dict[str, int]:
    """Per-device payload bytes of each collective kind in the module."""
    out: Dict[str, int] = {}
    for m in _OP_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        # fusions mentioning collectives in operands don't match: the regex
        # anchors on "= <shape> <kind>(" which only ops themselves produce.
        out[kind] = out.get(kind, 0) + _shape_bytes(shape_str)
    return out


def collective_bytes_detailed(hlo_text: str) -> Dict[str, Dict[str, int]]:
    """Per (collective kind, element dtype) payload bytes."""
    out: Dict[str, Dict[str, int]] = {}
    for m in _OP_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        for dtype, dims in _SHAPE_RE.findall(shape_str):
            if dtype not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            slot = out.setdefault(kind, {})
            slot[dtype] = slot.get(dtype, 0) + n * _DTYPE_BYTES[dtype]
    return out


def correct_promoted_f32(detailed: Dict[str, Dict[str, int]]
                         ) -> Dict[str, int]:
    """XLA:CPU float-normalization promotes bf16 tensors to f32, so in a
    bf16-weights program every large f32 collective payload is logically
    bf16 (only loss scalars / norm stats are genuinely f32, and they are
    negligible).  Halve the f32 portion to recover the TPU-logical bytes.
    Applied ONLY for bf16-parameter variants (see EXPERIMENTS.md §Perf
    methodology); baseline fp32-parameter programs are reported raw.

    Kept for parity of the parser with the JAX package: the port's own
    collectives carry their true dtype, and the dry run applies no
    correction to them.
    """
    out = {}
    for kind, per_dtype in detailed.items():
        total = 0
        for dtype, b in per_dtype.items():
            total += b // 2 if dtype == "f32" else b
        out[kind] = total
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N·D forward-only,
    with N = active params (MoE counts top-k experts only)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def roofline_report(*, cfg, shape, n_chips: int,
                    flops_per_device: float, bytes_per_device: float,
                    collective_bytes_per_device: float) -> Dict:
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_bytes_per_device / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = flops_per_device * n_chips
    step_s = max(terms.values())
    useful_ratio = mf / hlo_flops_global if hlo_flops_global else 0.0
    # roofline fraction: useful model flops per second vs the machine peak,
    # if the step ran at the max-term estimate
    mfu_bound = (mf / step_s) / (n_chips * PEAK_FLOPS) if step_s else 0.0
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bound": bound,
        "model_flops": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": mfu_bound,
        "chips": n_chips,
    }
