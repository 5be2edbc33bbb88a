"""Public DVV kernel functions: the CUDA kernel for tensors on the card,
the plain torch version (``ref``) for tensors on the CPU.

A tensor on the card always goes to the kernel: if it cannot be built or
launched, the call raises — there is no fallback.  ``launches`` counts the
kernel launches (``dvv_ops.launches``); ``reset_launches`` zeroes it.

The store's front ends take numpy arrays and hand numpy back:
``dvv_sync_mask_bucketed(device)`` is the ``mask_fn`` of PUT and
anti-entropy, ``dvv_read_sweep_bucketed(device)`` the ``sweep_fn`` of the
quorum read.  They pad nothing (the kernels take N, K and R at run time)
and keep counting the shapes' power-of-two buckets (``cache_info``).  On
the card a sweep packs its four arrays into one reused pinned staging
buffer, 16-byte aligned, and makes one C call: one async copy in, the
kernel, one async copy of the mask (and ceilings) out, one wait
(``dvv_ops.stage_sweep``); ``h2d_copies`` and ``d2h_copies`` count the
copies.  On the CPU the plain versions take the arrays as they are.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

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


def staging_layout(N: int, K: int, R: int, ceil: bool
                   ) -> Tuple[List[int], int, int, int]:
    """Where a sweep's arrays sit in the staging buffer: byte offsets of
    vvs, dot_ids, dot_ns, valid (the inputs, copied in), mask and the
    ceilings (-1 without them; copied out), each 16-byte aligned; then the
    bytes copied in, and the offset and length of what is copied out."""
    sizes = (N * K * R * 4, N * K * 4, N * K * 4, N * K, N * K, N * R * 8)
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += -(-size // 16) * 16
    in_bytes = offsets[3] + N * K
    end = offsets[5] + N * R * 8 if ceil else offsets[4] + N * K
    if not ceil:
        offsets[5] = -1
    return offsets, in_bytes, offsets[4], end - offsets[4]


class BucketedSweep(BucketedSyncMask):
    """The store's front end over the survival sweep on ``device``, numpy
    in and numpy out (see the module note): the mask alone (the ``mask_fn``
    of PUT and anti-entropy), or with ``ceil`` the mask and the ceilings
    (the read's ``sweep_fn``).  The staging buffers grow to the largest
    sweep seen and are reused as shapes shrink."""

    def __init__(self, device="cuda", *, ceil: bool = False):
        super().__init__(dvv_read_sweep if ceil else dvv_sync_mask,
                         device=device)
        self.ceil = ceil
        self.h2d_copies = 0
        self.d2h_copies = 0
        self._host = self._dev = self._host_np = None
        self._lock = threading.Lock()

    def _staging(self, nbytes: int) -> np.ndarray:
        """The pinned host buffer (and its device twin) of at least
        ``nbytes``, grown by doubling, as a numpy view."""
        have = 0 if self._host is None else self._host.numel()
        if nbytes > have:
            cap = -(-max(nbytes, 2 * have, 1 << 16) // 4096) * 4096
            card = self.device.type == "cuda"
            self._host = torch.empty(cap, dtype=torch.uint8, pin_memory=card)
            self._dev = torch.empty(cap, dtype=torch.uint8,
                                    device=self.device) if card else None
            self._host_np = self._host.numpy()
        return self._host_np

    def __call__(self, vvs, dot_ids, dot_ns, valid):
        vvs = np.asarray(vvs, np.int32)
        N, K, R = vvs.shape
        if N == 0 or K == 0:
            mask = np.zeros((N, K), bool)
            return (mask, np.zeros((N, R), np.int64)) if self.ceil else mask
        if self.device.type != "cuda":
            self._count(vvs.shape)
            got = self._fn(*(torch.from_numpy(np.ascontiguousarray(a, dt))
                             for a, dt in ((vvs, np.int32),
                                           (dot_ids, np.int32),
                                           (dot_ns, np.int32),
                                           (valid, bool))))
            return tuple(t.numpy() for t in got) if self.ceil \
                else got.numpy()
        offs, in_bytes, out_off, out_bytes = staging_layout(N, K, R,
                                                            self.ceil)
        with self._lock:              # one staging buffer for all callers
            self._count((N, K, R))
            host = self._staging(out_off + out_bytes)

            def view(i, dtype, shape):
                n = int(np.prod(shape)) * np.dtype(dtype).itemsize
                return host[offs[i]:offs[i] + n].view(dtype).reshape(shape)

            views = (view(0, np.int32, (N, K, R)), view(1, np.int32, (N, K)),
                     view(2, np.int32, (N, K)), view(3, np.bool_, (N, K)))
            for dst, src in zip(views, (vvs, dot_ids, dot_ns, valid)):
                dst[...] = src
            _cuda.stage_sweep(self._host, self._dev, in_bytes, out_off,
                              out_bytes, offs, N, K, R)
            self.h2d_copies += 1
            self.d2h_copies += 1
            mask = view(4, np.bool_, (N, K)).copy()
            if self.ceil:
                return mask, view(5, np.int64, (N, R)).copy()
            return mask


class BucketedReadSweep(BucketedSweep):
    """The read sweep's front end: the ``sweep_fn`` that
    ``KVCluster.get_many(use_kernel=True)`` hands ``quorum_merge_many``;
    returns (mask bool[N, K], ceilings int64[N, R])."""

    def __init__(self, device="cuda"):
        super().__init__(device, ceil=True)


_fronts: Dict[Tuple[str, torch.device], BucketedSweep] = {}


def dvv_sync_mask_bucketed(device="cuda") -> BucketedSweep:
    """The shared ``dvv_sync_mask`` front end on ``device``."""
    key = ("sync_mask", torch.device(device))
    if key not in _fronts:
        _fronts[key] = BucketedSweep(device)
    return _fronts[key]


def dvv_read_sweep_bucketed(device="cuda") -> BucketedReadSweep:
    """The shared ``dvv_read_sweep`` front end on ``device``."""
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
