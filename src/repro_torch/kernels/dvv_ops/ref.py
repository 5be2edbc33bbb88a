"""Plain torch versions of the dvv_ops kernels.

Thin wrappers over ``repro_torch.core.batched`` — the semantics each CUDA
kernel is held against on the card, and what ``ops`` runs for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.batched import dominates, leq, merge_context, sync_mask


def leq_ref(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    return leq(vx, ix, nx, vy, iy, ny)


def dominates_ref(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    return dominates(vx, ix, nx, vy, iy, ny)


def concurrent_ref(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    a = leq(vx, ix, nx, vy, iy, ny)
    b = leq(vy, iy, ny, vx, ix, nx)
    return ~a & ~b


def sync_mask_ref(vvs, dot_ids, dot_ns, valid) -> torch.Tensor:
    return sync_mask(vvs, dot_ids, dot_ns, valid)


def read_sweep_ref(vvs, dot_ids, dot_ns, valid
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survival mask, then the ceiling ⌈S⌉ of the survivors (int64)."""
    mask = sync_mask(vvs, dot_ids, dot_ns, valid)
    if vvs.shape[-2] == 0:                   # no rows: every ceiling is 0
        return mask, vvs.new_zeros(vvs.shape[:-2] + vvs.shape[-1:],
                                   dtype=torch.int64)
    return mask, merge_context(vvs, dot_ids, dot_ns, mask).to(torch.int64)
