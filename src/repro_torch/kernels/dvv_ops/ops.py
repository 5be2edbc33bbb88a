"""Public DVV kernel functions: the CUDA kernel for tensors on the card,
the plain torch version (``ref``) for tensors on the CPU.

A tensor on the card always goes to the kernel: if it cannot be built or
launched, the call raises — there is no fallback.  ``launches`` counts the
kernel launches (``dvv_ops.launches``); ``reset_launches`` zeroes it.

The bucketed front ends take the store's numpy arrays, pad them to the
power-of-two bucket (``core.batched.bucket_shape``), run the sweep on their
device and hand numpy back: ``dvv_sync_mask_bucketed(device)`` is the
``mask_fn`` of PUT and anti-entropy, ``dvv_read_sweep_bucketed(device)``
the ``sweep_fn`` of the quorum read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ...core.batched import BucketedSyncMask
from . import dvv_ops as _cuda
from .dvv_ops import launches, reset_launches
from .ref import leq_ref, read_sweep_ref, sync_mask_ref


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"dvv_ops runs on cuda or cpu tensors, not {t.device}")


def dvv_leq(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    """Batched history-inclusion over N flat pairs: bool[N]."""
    if _on_card(vx):
        return _cuda.leq(vx, ix, nx, vy, iy, ny)
    return leq_ref(vx, ix, nx, vy, iy, ny)


def dvv_sync_mask(vvs, dot_ids, dot_ns, valid) -> torch.Tensor:
    """Fused per-key survival sweep: bool[N, K].  Drop-in for
    ``core.batched.sync_mask`` on [N, K, R] inputs."""
    if _on_card(vvs):
        return _cuda.sync_mask(vvs, dot_ids, dot_ns, valid)
    return sync_mask_ref(vvs, dot_ids, dot_ns, valid)


def dvv_read_sweep(vvs, dot_ids, dot_ns, valid
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused quorum-read sweep: survival mask bool[N, K] plus each key's
    §5.4 ceiling ⌈S⌉ over its surviving rows, int64[N, R].  Equals
    ``core.batched.sync_mask_np`` + ``grouped_ceiling_np`` over the
    survivors."""
    if _on_card(vvs):
        return _cuda.read_sweep(vvs, dot_ids, dot_ns, valid)
    return read_sweep_ref(vvs, dot_ids, dot_ns, valid)


class BucketedReadSweep(BucketedSyncMask):
    """Shape-bucketed front end over ``dvv_read_sweep`` on ``device``.
    Pad rows are invalid (inert for both mask and ceiling) and pad replica
    columns come back as zero ceilings, sliced off on return.  This is the
    ``sweep_fn`` that ``KVCluster.get_many(use_kernel=True)`` hands
    ``quorum_merge_many``."""

    def __init__(self, device="cuda"):
        super().__init__(dvv_read_sweep, device=device)

    def __call__(self, vvs, dot_ids, dot_ns, valid
                 ) -> Tuple[np.ndarray, np.ndarray]:
        vvs = np.asarray(vvs, np.int32)
        N, K, R = vvs.shape
        if N == 0 or K == 0:
            return np.zeros((N, K), bool), np.zeros((N, R), np.int64)
        args = self._bucket(vvs, np.asarray(dot_ids, np.int32),
                            np.asarray(dot_ns, np.int32),
                            np.asarray(valid, bool))
        mask, ceil = self._fn(*args)
        return mask.cpu().numpy()[:N, :K], ceil.cpu().numpy()[:N, :R]


_fronts: Dict[Tuple[str, torch.device], BucketedSyncMask] = {}


def dvv_sync_mask_bucketed(device="cuda") -> BucketedSyncMask:
    """The shared bucketed ``dvv_sync_mask`` front end on ``device``."""
    key = ("sync_mask", torch.device(device))
    if key not in _fronts:
        _fronts[key] = BucketedSyncMask(dvv_sync_mask, device=device)
    return _fronts[key]


def dvv_read_sweep_bucketed(device="cuda") -> BucketedReadSweep:
    """The shared bucketed ``dvv_read_sweep`` front end on ``device``."""
    key = ("read_sweep", torch.device(device))
    if key not in _fronts:
        _fronts[key] = BucketedReadSweep(device)
    return _fronts[key]


def dvv_dominates(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    """x dominates y ⟺ y ≤ x."""
    return dvv_leq(vy, iy, ny, vx, ix, nx)


def dvv_concurrent(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    a = dvv_leq(vx, ix, nx, vy, iy, ny)
    b = dvv_leq(vy, iy, ny, vx, ix, nx)
    return ~a & ~b


def antientropy_obsolete(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    """Anti-entropy sweep primitive: for each key k, is the local version
    x_k *strictly dominated* by the incoming y_k (and hence discardable)?
    Strict: x ≤ y ∧ ¬(y ≤ x)."""
    le = dvv_leq(vx, ix, nx, vy, iy, ny)
    ge = dvv_leq(vy, iy, ny, vx, ix, nx)
    return le & ~ge
