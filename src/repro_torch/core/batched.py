"""Array-encoded DVV algebra: host conversions, numpy twins, torch algebra.

A production deployment tracks millions of keys; anti-entropy between two
replica nodes compares the clock sets of every transferred key.  Doing that
clock-by-clock in Python is the CPU-era formulation; on the GPU we batch.

Encoding (per clock, replica universe of fixed size R):
    vv     : int32[R]   — vv[r] = m, the contiguous range 1..m for replica r
    dot_id : int32[]    — replica index of the single dot (−1 if none)
    dot_n  : int32[]    — the dot's event counter n (> vv[dot_id]; 0 if none)

Every clock the store keeps has at most one dot (paper §5.3: all stored
clocks have exactly one triple component), so this encoding is *exact*, not
an approximation.  ``repro_torch.kernels.dvv_ops`` provides the CUDA kernels
for the dominance sweep; the torch functions here are their plain versions,
beside the numpy twins and the host-side conversion helpers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .dvv import DVV

NO_DOT = -1


# ---------------------------------------------------------------------------
# Host-side conversions (pure Python <-> arrays).
# ---------------------------------------------------------------------------

def encode(clock: DVV, universe: Sequence[str]) -> Tuple[np.ndarray, int, int]:
    index = {r: i for i, r in enumerate(universe)}
    vv = np.zeros(len(universe), dtype=np.int32)
    dot_id, dot_n = NO_DOT, 0
    for (r, m, n) in clock.components:
        if r not in index:
            raise ValueError(f"replica {r!r} outside universe {universe}")
        vv[index[r]] = m
        if n:
            if dot_id != NO_DOT:
                raise ValueError("array encoding supports at most one dot")
            dot_id, dot_n = index[r], n
    return vv, dot_id, dot_n


def decode(vv: np.ndarray, dot_id: int, dot_n: int,
           universe: Sequence[str]) -> DVV:
    comps: List[Tuple[str, int, int]] = []
    for i, r in enumerate(universe):
        m = int(vv[i])
        n = int(dot_n) if i == int(dot_id) else 0
        if m or n:
            comps.append((r, m, n))
    return DVV(tuple(comps))


def encode_batch(clocks: Sequence[DVV], universe: Sequence[str]):
    vvs = np.zeros((len(clocks), len(universe)), dtype=np.int32)
    dot_ids = np.full((len(clocks),), NO_DOT, dtype=np.int32)
    dot_ns = np.zeros((len(clocks),), dtype=np.int32)
    for k, c in enumerate(clocks):
        vvs[k], dot_ids[k], dot_ns[k] = encode(c, universe)
    return vvs, dot_ids, dot_ns


# ---------------------------------------------------------------------------
# Numpy twins of the clock algebra — used by the resident packed store
# (store/packed.py) for per-key control-plane operations where a device
# dispatch per PUT would dominate.  Semantics identical to the torch versions
# below; both are conformance-tested against the pure-Python DVV objects.
# ---------------------------------------------------------------------------

def leq_np(vx: np.ndarray, ix: np.ndarray, nx: np.ndarray,
           vy: np.ndarray, iy: np.ndarray, ny: np.ndarray) -> np.ndarray:
    """history(x) ⊆ history(y), batched over leading dims (numpy)."""
    R = vx.shape[-1]
    if R == 0:
        # Empty replica universe: all histories are empty, hence equal.
        # (No dot can exist — a dot names a replica.)
        return np.ones(np.broadcast(np.asarray(ix), np.asarray(iy)).shape,
                       bool)
    ar = np.arange(R, dtype=np.int32)
    iy_b = np.asarray(iy)[..., None]
    ny_b = np.asarray(ny)[..., None]
    dot_extends = (iy_b == ar) & (vx == ny_b) & (vx == vy + 1)
    range_ok = np.all((vx <= vy) | dot_extends, axis=-1)

    has_dot = np.asarray(ix) != NO_DOT
    ix_safe = np.clip(ix, 0, R - 1)
    vy_at_ix = np.take_along_axis(
        np.asarray(vy), np.asarray(ix_safe)[..., None], axis=-1)[..., 0]
    dot_ok = (nx <= vy_at_ix) | ((iy == ix) & (nx == ny))
    dot_ok = np.where(has_dot, dot_ok, True)
    return range_ok & dot_ok


def sync_mask_np(vvs: np.ndarray, dot_ids: np.ndarray, dot_ns: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """Numpy twin of ``sync_mask`` (below): survival of a combined clock set.

    vvs [..., K, R]; dot_ids/dot_ns/valid [..., K].  Returns bool [..., K].
    """
    K = vvs.shape[-2]
    vx = vvs[..., :, None, :]
    vy = vvs[..., None, :, :]
    ix = dot_ids[..., :, None]
    iy = dot_ids[..., None, :]
    nx = dot_ns[..., :, None]
    ny = dot_ns[..., None, :]
    le = leq_np(vx, ix, nx, vy, iy, ny)
    ge = leq_np(vy, iy, ny, vx, ix, nx)
    strictly_below = le & ~ge
    equal = le & ge
    idx = np.arange(K, dtype=np.int32)
    dup_earlier = equal & (idx[..., None, :] < idx[..., :, None])
    other_valid = valid[..., None, :]
    dominated = np.any((strictly_below | dup_earlier) & other_valid, axis=-1)
    return valid & ~dominated


def grouped_ceil_at_np(vv_at_r: np.ndarray, dot_ids: np.ndarray,
                       dot_ns: np.ndarray, groups: np.ndarray,
                       n_groups: int, r_index: int) -> np.ndarray:
    """⌈S⌉_r per *group* over stacked clock rows — the batched twin of
    ``effective_ceil_np`` used by multi-key PUT minting.

    ``vv_at_r`` is the r-column of each row's vv; ``groups`` assigns each
    row to one of ``n_groups`` keys.  One ``np.maximum.at`` scatter per
    signal — no per-key Python loop.
    """
    out = np.zeros(n_groups, np.int32)
    if len(vv_at_r):
        np.maximum.at(out, groups, vv_at_r.astype(np.int32))
        at_r = np.asarray(dot_ids) == r_index
        if at_r.any():
            np.maximum.at(out, np.asarray(groups)[at_r],
                          np.asarray(dot_ns, np.int32)[at_r])
    return out


def grouped_ceiling_np(vvs: np.ndarray, dot_ids: np.ndarray,
                       dot_ns: np.ndarray, groups: np.ndarray,
                       n_groups: int) -> np.ndarray:
    """Per-*group* §5.4 ceiling ⌈S⌉ over stacked clock rows — the
    segment-reduced twin of ``store.packed.ceiling_from_rows`` used by the
    batched read plane (``quorum_merge_many``).

    ``vvs`` is int32[M, R]; ``groups`` assigns each row to one of
    ``n_groups`` keys.  Returns int64[n_groups, R]: per group, the column
    max of the rows with the dots folded in — two ``np.maximum.at``
    scatters, no per-key Python loop.
    """
    R = int(vvs.shape[-1])
    out = np.zeros((n_groups, R), np.int64)
    if vvs.shape[0] == 0 or R == 0:
        return out
    g = np.asarray(groups, np.int64)
    np.maximum.at(out, g, np.asarray(vvs, np.int64))
    has_dot = np.asarray(dot_ids) != NO_DOT
    if has_dot.any():
        flat = out.reshape(-1)               # view: scatters land in ``out``
        np.maximum.at(flat, g[has_dot] * R
                      + np.asarray(dot_ids, np.int64)[has_dot],
                      np.asarray(dot_ns, np.int64)[has_dot])
    return out


def effective_ceil_np(vvs: np.ndarray, dot_ids: np.ndarray,
                      dot_ns: np.ndarray, r_index: int) -> int:
    """⌈S⌉_r over a clock set given as arrays: max of vv[:, r] and any dot at r."""
    if vvs.shape[0] == 0:
        return 0
    top = int(vvs[:, r_index].max(initial=0))
    at_r = dot_ids == r_index
    if at_r.any():
        top = max(top, int(dot_ns[at_r].max(initial=0)))
    return top


# ---------------------------------------------------------------------------
# Vectorized clock algebra (torch).  Plain tensor code on any device, batched
# over leading dims: vv [..., R], dot_id [...], dot_n [...].  These are the
# plain versions the CUDA kernels of ``kernels.dvv_ops`` are held against.
# ---------------------------------------------------------------------------

def leq(vx: torch.Tensor, ix: torch.Tensor, nx: torch.Tensor,
        vy: torch.Tensor, iy: torch.Tensor, ny: torch.Tensor) -> torch.Tensor:
    """history(x) ⊆ history(y), batched over leading dims.

    Range coverage per replica r: 1..vx[r] ⊆ (1..vy[r] ∪ {ny if iy==r})
        ⟺ vx[r] ≤ vy[r]  ∨  (iy==r ∧ vx[r] == ny == vy[r]+1)
    Dot coverage (if ix != NO_DOT): nx ≤ vy[ix] ∨ (iy==ix ∧ nx==ny)
    """
    R = vx.shape[-1]
    if R == 0:
        # Empty replica universe: all histories are empty, hence equal
        # (``torch.gather`` refuses an empty dimension, so say it here).
        return torch.ones(torch.broadcast_shapes(ix.shape, iy.shape),
                          dtype=torch.bool, device=vx.device)
    ar = torch.arange(R, dtype=torch.int32, device=vx.device)
    iy_b = iy[..., None]
    ny_b = ny[..., None]
    dot_extends = (iy_b == ar) & (vx == ny_b) & (vx == vy + 1)
    range_ok = torch.all((vx <= vy) | dot_extends, dim=-1)

    has_dot = ix != NO_DOT
    # gather vy[ix] safely (ix may be -1; clamp and mask)
    ix_safe = torch.clamp(ix, 0, R - 1).long()
    vy_at_ix = torch.take_along_dim(vy, ix_safe[..., None], dim=-1)[..., 0]
    dot_ok = (nx <= vy_at_ix) | ((iy == ix) & (nx == ny))
    dot_ok = torch.where(has_dot, dot_ok, True)
    return range_ok & dot_ok


def dominates(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    """x dominates y  ⟺  y ≤ x."""
    return leq(vy, iy, ny, vx, ix, nx)


def concurrent(vx, ix, nx, vy, iy, ny) -> torch.Tensor:
    return ~leq(vx, ix, nx, vy, iy, ny) & ~leq(vy, iy, ny, vx, ix, nx)


def effective_vv(vv: torch.Tensor, dot_id: torch.Tensor,
                 dot_n: torch.Tensor) -> torch.Tensor:
    """Fold the dot into the vector: ``max(vv[r], n)`` at the dot's column.

    Used by ``merge_context``: the ⌈·⌉ ceiling of the paper takes max(m, n),
    which is safe when summarizing a *downset* context.
    """
    R = vv.shape[-1]
    ar = torch.arange(R, dtype=torch.int32, device=vv.device)
    at_dot = dot_id[..., None] == ar
    return torch.where(at_dot, torch.maximum(vv, dot_n[..., None]), vv)


def merge_context(vvs: torch.Tensor, dot_ids: torch.Tensor,
                  dot_ns: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """⌈S⌉ per replica over a clock *set* (axis -2), masked by ``valid``.

    Returns a plain vv[..., R] — the context summary used by ``update``.
    Relies on the §5.4 downset invariant of the context.
    """
    eff = effective_vv(vvs, dot_ids, dot_ns)
    eff = torch.where(valid[..., None], eff, 0)
    return torch.amax(eff, dim=-2)


def update_clock(ctx_vv: torch.Tensor, local_max_r: torch.Tensor,
                 r_index: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mint the new clock (paper §5.3) in array form.

    ctx_vv      : [..., R] — merged context ceiling ⌈S⌉
    local_max_r : [...]    — ⌈Sr⌉_r at the coordinator
    r_index     : [...]    — coordinator replica index
    Returns (vv, dot_id, dot_n) with vv = ctx_vv and the dot at r.
    """
    dot_n = torch.clamp(local_max_r, min=0) + 1
    return ctx_vv, r_index.to(torch.int32), dot_n.to(torch.int32)


def sync_mask(vvs: torch.Tensor, dot_ids: torch.Tensor, dot_ns: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Which clocks of a combined set survive sync (are not strictly dominated).

    vvs [..., K, R]; dot_ids/dot_ns/valid [..., K].  Returns bool [..., K].
    A clock survives iff no *other valid* clock strictly dominates it.
    Pairs of equal clocks (same history) keep the lowest index.
    """
    K = vvs.shape[-2]
    vx = vvs[..., :, None, :]
    vy = vvs[..., None, :, :]
    ix = dot_ids[..., :, None]
    iy = dot_ids[..., None, :]
    nx = dot_ns[..., :, None]
    ny = dot_ns[..., None, :]
    le = leq(vx, ix, nx, vy, iy, ny)          # [..., K, K]  x ≤ y
    ge = leq(vy, iy, ny, vx, ix, nx)          # x ≥ y
    strictly_below = le & ~ge
    equal = le & ge
    idx = torch.arange(K, dtype=torch.int32, device=vvs.device)
    dup_earlier = equal & (idx[..., None, :] < idx[..., :, None])  # equal to an earlier clock
    other_valid = valid[..., None, :]
    dominated = torch.any((strictly_below | dup_earlier) & other_valid,
                          dim=-1)
    return valid & ~dominated


# ---------------------------------------------------------------------------
# Shape-bucketed sync_mask dispatch (DESIGN.md §6).
#
# Delta anti-entropy rounds produce grouped [N, K, R] tensors of *arbitrary*
# small shapes.  Bucketing pads each dim to the next power of two (with small
# floors) so the whole sweep space collapses into a handful of shapes; the
# hit/miss counters say how many distinct shapes a workload produced.  Pad rows are
# inert by construction: ``valid`` is False, and an invalid clock can
# neither survive (mask = valid & …) nor dominate (domination is masked by
# ``other_valid``); zero-filled replica columns denote empty ranges, which
# is the exact meaning of an absent replica.
# ---------------------------------------------------------------------------

def _ceil_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def bucket_shape(n: int, k: int, r: int, *, min_n: int = 8, min_k: int = 2,
                 min_r: int = 8) -> Tuple[int, int, int]:
    """The power-of-two (N_block, K_pad, R_pad) bucket containing [n, k, r]."""
    return (max(min_n, _ceil_pow2(n)), max(min_k, _ceil_pow2(k)),
            max(min_r, _ceil_pow2(r)))


def pad_sync_args(vvs: np.ndarray, dot_ids: np.ndarray, dot_ns: np.ndarray,
                  valid: np.ndarray, shape: Tuple[int, int, int]):
    """Zero/NO_DOT/False-pad a grouped sync tensor up to ``shape``."""
    N, K, R = vvs.shape
    Nb, Kb, Rb = shape
    return (np.pad(vvs, ((0, Nb - N), (0, Kb - K), (0, Rb - R))),
            np.pad(dot_ids, ((0, Nb - N), (0, Kb - K)),
                   constant_values=NO_DOT),
            np.pad(dot_ns, ((0, Nb - N), (0, Kb - K))),
            np.pad(valid, ((0, Nb - N), (0, Kb - K))))


class BucketedSyncMask:
    """A ``mask_fn`` that shape-buckets its numpy input and runs ``impl``
    on ``device``.

    ``impl`` is any sync_mask-compatible function on tensors ([N, K, R] +
    three [N, K] → bool [N, K]); the default is the torch ``sync_mask``
    above.  The padded arrays are copied to ``device`` and the mask comes
    back as numpy.  PyTorch runs eagerly, so there is no compiled callable
    per bucket to keep warm; ``hits``/``misses`` still count repeated vs
    new buckets, which the delta and serving paths report.
    """

    def __init__(self, impl=None, *, device="cuda"):
        self._fn = sync_mask if impl is None else impl
        self.device = torch.device(device)
        self._seen: set = set()
        self.hits = 0
        self.misses = 0

    def _count(self, shape: Tuple[int, int, int]):
        """Count ``shape``'s bucket as a hit or a miss and return it."""
        key = bucket_shape(*shape)
        if key in self._seen:
            self.hits += 1
        else:
            self.misses += 1
            self._seen.add(key)
        return key

    def _bucket(self, vvs, dot_ids, dot_ns, valid):
        """Count the bucket and pad the arrays to it as tensors on
        ``device``."""
        key = self._count(vvs.shape)
        return [torch.from_numpy(a).to(self.device)
                for a in pad_sync_args(vvs, dot_ids, dot_ns, valid, key)]

    def __call__(self, vvs, dot_ids, dot_ns, valid) -> np.ndarray:
        vvs = np.asarray(vvs, np.int32)
        N, K, _ = vvs.shape
        if N == 0 or K == 0:
            return np.zeros((N, K), bool)
        args = self._bucket(vvs, np.asarray(dot_ids, np.int32),
                            np.asarray(dot_ns, np.int32),
                            np.asarray(valid, bool))
        return self._fn(*args).cpu().numpy()[:N, :K]

    def cache_info(self) -> Dict[str, object]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "buckets": sorted(self._seen)}

    def reset_stats(self) -> None:
        """Zero the hit/miss counters; the bucket set stays.  Lets the
        serving path report cross-flush hit rates per measurement window."""
        self.hits = 0
        self.misses = 0
