"""Architecture registry + the assigned (arch × input-shape) matrix.

``--arch <id>`` everywhere resolves through ``get_config``.  ``CELLS``
enumerates the dry-run/roofline matrix with the skip rules of DESIGN.md §5:
  * encoder-only archs have no decode step  → skip decode_32k, long_500k
  * pure full-attention archs               → skip long_500k
  * SSM / hybrid archs                      → run long_500k
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..models.config import ModelConfig
from . import (
    gemma2_9b, gemma_2b, granite_8b, grok_1_314b, hubert_xlarge,
    jamba_1_5_large_398b, mamba2_780m, qwen2_vl_7b, qwen3_14b,
    qwen3_moe_30b_a3b,
)

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        jamba_1_5_large_398b, gemma2_9b, qwen3_14b, granite_8b, gemma_2b,
        grok_1_314b, qwen3_moe_30b_a3b, hubert_xlarge, qwen2_vl_7b,
        mamba2_780m,
    )
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.kind == "decode" and not cfg.is_decoder:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return None


def cells(include_skipped: bool = False
          ) -> List[Tuple[ModelConfig, ShapeSpec, Optional[str]]]:
    out = []
    for cfg in REGISTRY.values():
        for shape in SHAPES.values():
            reason = cell_skip_reason(cfg, shape)
            if reason is None or include_skipped:
                out.append((cfg, shape, reason))
    return out


CELLS = cells()

__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "ShapeSpec", "SHAPES",
           "cells", "CELLS", "cell_skip_reason"]
