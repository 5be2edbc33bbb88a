"""Array-resident version store: packed int32 clocks as the source of truth.

``ReplicaNode`` historically kept per-key version sets as Python ``DVV``
objects and re-encoded them to arrays on every bulk anti-entropy round — an
O(keys) object-walk tax on the hot path.  ``PackedVersionStore`` inverts
that: the structure-of-arrays encoding of ``core.batched`` *is* the resident
representation, and object clocks exist only at the client API edge
(GET contexts, PUT acks).  See DESIGN.md §3.4.

Layout (structure of arrays over "slots"; one slot = one stored version):

    vv      : int32[cap, R]  — per-replica contiguous ranges 1..m
    dot_id  : int32[cap]     — replica column of the single dot (−1 if none)
    dot_n   : int32[cap]     — the dot's counter (0 if none)
    key_ix  : int32[cap]     — interned key of the slot
    valid   : bool[cap]      — live/dead (dead slots are reclaimed by compact)
    values  : list[Any]      — the opaque payloads, aligned with slots

The replica universe is *dynamic*: replica ids are interned on first sight
and the ``vv`` matrix grows columns in place (zero-fill is exact — absent
ids have empty ranges).  Capacity grows by doubling; ``compact()`` drops
dead slots when they outnumber the live ones.

Anti-entropy ships ``PackedPayload`` — the same arrays plus the sender's
replica/key interning tables — so a full round is: one column remap
(vectorized gather), one grouped scatter, one ``sync_mask`` evaluation
(the numpy twin or the fused CUDA kernel), one masked write-back.  No per-key DVV
object is created anywhere on that path.

Steady-state rounds are *delta* rounds (DESIGN.md §6): the store keeps an
incremental digest tree — every live slot owns a canonical 64-bit hash
(independent of column order, slot order and trailing zero columns), and
each of ``n_buckets`` key ranges holds the xor-fold of its slots' hashes,
updated in O(changed slots) on insert/kill (compaction moves slots but not
set membership, so digests are untouched).  Two replicas exchange
``StoreDigest`` snapshots, diff them down the tree, and ship only the
divergent buckets via ``payload(key_ranges=...)`` — wire and compute
proportional to divergence, not store size.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Mapping, \
    Optional, Sequence, Tuple

import numpy as np

from ..core import batched as B
from ..core.dvv import DVV
from .context import CausalContext
from .version import Version

NO_DOT = B.NO_DOT

_INITIAL_SLOTS = 64
_INITIAL_REPLICAS = 4
_INITIAL_KEYS = 64

DIGEST_BUCKETS = 256          # initial leaf key-ranges of the digest tree
DIGEST_FANOUT = 16            # children per internal tree node
_SLOTS_PER_BUCKET = 4         # growth trigger: live slots per leaf
_MAX_BUCKETS = 1 << 20
_BUCKET_GROWTH = 4            # widen by 4x so rebuilds amortize

_U64 = np.uint64
_GOLD = _U64(0x9E3779B97F4A7C15)    # splitmix64 increment
_DOT_SALT = _U64(0xD07D07D07D07D07D)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays (wraps mod 2^64)."""
    with np.errstate(over="ignore"):
        x = (np.asarray(x, _U64) + _GOLD)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def _hash_str(s: str) -> int:
    """Stable (process-independent) 64-bit hash of an interning-table entry."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


def _hash_value(value: Any) -> int:
    """Stable 64-bit hash of a slot's *value content* (priced at its repr,
    like every serialization stand-in in this codebase).  Feeds the store's
    value root — the content check that closes the §6.1 clock+key digest
    gap for non-protocol stores (see ``value_root``)."""
    return _hash_str(repr(value))


def ceiling_from_rows(vv: np.ndarray, dot_id: np.ndarray, dot_n: np.ndarray
                      ) -> np.ndarray:
    """Per-replica ceiling ⌈S⌉ over packed clock rows: column max with the
    dots folded in.  The one §5.4 compaction shared by GET-context
    production (``context_of``, the quorum merge).  The single-group view
    of ``core.batched.grouped_ceiling_np`` — the batched read plane calls
    the grouped form directly, one segment reduce for all keys."""
    return B.grouped_ceiling_np(vv, dot_id, dot_n,
                                np.zeros(vv.shape[0], np.int64), 1)[0]


def remap_rows(vv: np.ndarray, dot_id: np.ndarray, col_map: np.ndarray,
               R: int) -> Tuple[np.ndarray, np.ndarray]:
    """Land packed clock rows in a target universe with one gather:
    ``col_map[j]`` is the target column of source column ``j``.  Returns
    ``(vv int32[M, R], dot_id int32[M])`` with absent dots (``NO_DOT``)
    preserved.  The one remap shared by payload application, the quorum
    merge and read-repair payload assembly."""
    out = np.zeros((vv.shape[0], R), np.int32)
    if len(col_map):
        out[:, col_map] = vv
    did = np.where(dot_id != NO_DOT,
                   col_map[np.clip(dot_id, 0, None)] if len(col_map)
                   else dot_id,
                   NO_DOT).astype(np.int32)
    return out, did


def key_bucket(key: str, n_buckets: int = DIGEST_BUCKETS) -> int:
    """The digest leaf a key belongs to — a pure function of the key string,
    so every replica assigns identical ranges regardless of interning order."""
    return _hash_str(key) & (n_buckets - 1)


@dataclass(frozen=True)
class StoreDigest:
    """A digest-tree snapshot: ``leaves[b]`` is the xor-fold of the canonical
    slot hashes of every live version whose key falls in bucket ``b``.

    Equal content ⇒ equal digests; the converse holds up to 64-bit hash
    collisions (the full-payload round remains the correctness fallback —
    see the collision probe in tests/test_delta_sync.py).

    Widths are powers of two and *foldable*: because a key's bucket is
    ``hash & (W − 1)``, xor-folding a 2W-wide leaf vector in half yields
    exactly the W-wide digest of the same store, so trees of different
    widths (stores grow their width with size) diff at the narrower one.
    """

    leaves: np.ndarray                      # uint64[n_buckets]

    @property
    def n_buckets(self) -> int:
        return int(self.leaves.shape[0])

    def fold(self, width: int) -> "StoreDigest":
        """Exact down-projection to a narrower power-of-two width."""
        if width == self.n_buckets:
            return self
        if width > self.n_buckets or self.n_buckets % width:
            raise ValueError(
                f"cannot fold {self.n_buckets} leaves to width {width}")
        return StoreDigest(np.bitwise_xor.reduce(
            self.leaves.reshape(-1, width), axis=0))

    @property
    def root(self) -> int:
        return int(np.bitwise_xor.reduce(self.leaves)) if len(self.leaves) \
            else 0

    def levels(self) -> List[np.ndarray]:
        """Root-first xor-fold levels with fanout ``DIGEST_FANOUT``."""
        lvls = [self.leaves]
        while len(lvls[0]) > 1:
            a = lvls[0]
            pad = (-len(a)) % DIGEST_FANOUT
            if pad:
                a = np.pad(a, (0, pad))
            lvls.insert(0, np.bitwise_xor.reduce(
                a.reshape(-1, DIGEST_FANOUT), axis=1))
        return lvls

    def nbytes(self) -> int:
        """Phase-1 wire cost of shipping this digest (leaves + root)."""
        return int(self.leaves.nbytes) + 8

    def diff(self, other: "StoreDigest") -> np.ndarray:
        """Leaf buckets whose content differs, found by tree descent.

        Compares root first (the converged fast path is one 8-byte check),
        then only the children of differing internal nodes.  Mismatched
        widths are folded to the narrower side first; returned bucket ids
        are at that common width.
        """
        width = min(self.n_buckets, other.n_buckets)
        if self.n_buckets != other.n_buckets:
            return self.fold(width).diff(other.fold(width))
        mine, theirs = self.levels(), other.levels()
        cand = np.flatnonzero(mine[0] != theirs[0])
        for lvl in range(1, len(mine)):
            if len(cand) == 0:
                return cand
            children = (cand[:, None] * DIGEST_FANOUT
                        + np.arange(DIGEST_FANOUT)).ravel()
            children = children[children < len(mine[lvl])]
            cand = children[mine[lvl][children] != theirs[lvl][children]]
        return cand


@dataclass
class PackedPayload:
    """A bulk anti-entropy transfer: packed clocks + the sender's tables.

    ``key_ix`` indexes into ``keys``; ``vv`` columns follow ``replica_ids``.
    The receiver remaps columns into its own universe with one gather.
    """

    replica_ids: Tuple[str, ...]
    keys: Tuple[str, ...]
    vv: np.ndarray          # int32[M, R]
    dot_id: np.ndarray      # int32[M]
    dot_n: np.ndarray       # int32[M]
    key_ix: np.ndarray      # int32[M]
    values: Tuple[Any, ...]
    wall: Optional[np.ndarray] = None   # float64[M] PUT wall-times

    def __post_init__(self) -> None:
        if self.wall is None:
            self.wall = np.zeros(int(self.vv.shape[0]), np.float64)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PackedPayload):
            return NotImplemented
        return (self.replica_ids == other.replica_ids
                and self.keys == other.keys
                and np.array_equal(self.vv, other.vv)
                and np.array_equal(self.dot_id, other.dot_id)
                and np.array_equal(self.dot_n, other.dot_n)
                and np.array_equal(self.key_ix, other.key_ix)
                and np.array_equal(self.wall, other.wall)
                and self.values == other.values)

    def __len__(self) -> int:
        return int(self.vv.shape[0])

    def nbytes(self) -> int:
        """Wire size estimate: clock arrays + interning tables + values
        (values priced at their repr, the sim-transport's serialization)."""
        arrays = (self.vv.nbytes + self.dot_id.nbytes + self.dot_n.nbytes
                  + self.key_ix.nbytes + self.wall.nbytes)
        tables = (sum(len(k.encode()) for k in self.keys)
                  + sum(len(r.encode()) for r in self.replica_ids))
        values = sum(len(repr(v).encode()) for v in self.values)
        return int(arrays + tables + values)


def concat_payloads(payloads: Sequence[PackedPayload]) -> PackedPayload:
    """Concatenate payloads with disjoint key sets into one wire object
    under a union replica universe — the sender-side joiner for sharded
    stores (one ``("store", payload)`` message covering several shards)."""
    payloads = list(payloads)
    if len(payloads) == 1:
        return payloads[0]
    ids: List[str] = []
    index: Dict[str, int] = {}
    for p in payloads:
        for rid in p.replica_ids:
            if rid not in index:
                index[rid] = len(ids)
                ids.append(rid)
    Ru = len(ids)
    M = sum(len(p) for p in payloads)
    vv = np.zeros((M, Ru), np.int32)
    did = np.full(M, NO_DOT, np.int32)
    dn = np.zeros(M, np.int32)
    kix = np.zeros(M, np.int32)
    wall = np.zeros(M, np.float64)
    keys: List[str] = []
    values: List[Any] = []
    off = 0
    for p in payloads:
        koff = len(keys)
        keys.extend(p.keys)
        n = len(p)
        if not n:
            continue
        cols = np.asarray([index[r] for r in p.replica_ids], np.int64)
        vv[off: off + n], did[off: off + n] = \
            remap_rows(p.vv, p.dot_id, cols, Ru)
        dn[off: off + n] = p.dot_n
        wall[off: off + n] = p.wall
        kix[off: off + n] = p.key_ix + koff
        values.extend(p.values)
        off += n
    return PackedPayload(tuple(ids), tuple(keys), vv, did, dn, kix,
                         tuple(values), wall)


def split_payload(payload: PackedPayload, shards: int
                  ) -> Dict[int, PackedPayload]:
    """Partition a payload by key shard (top bits of the stable 64-bit key
    hash — ``sharding.shard_of_key``) — the receiver-side router that lets
    one wire payload land in per-shard stores.  Shards with no keys in the
    payload are absent from the result."""
    if shards <= 1:
        return {0: payload}
    from .sharding import shard_of_key
    key_shard = [shard_of_key(k, shards) for k in payload.keys]
    groups: Dict[int, List[int]] = {}
    for ix, s in enumerate(key_shard):
        groups.setdefault(s, []).append(ix)
    if len(groups) <= 1:
        return {s: payload for s in groups}
    out: Dict[int, PackedPayload] = {}
    n_keys = len(payload.keys)
    for s, kixs in groups.items():
        remap = np.full(n_keys, -1, np.int64)
        remap[kixs] = np.arange(len(kixs))
        rows = np.flatnonzero(remap[payload.key_ix] >= 0)
        out[s] = PackedPayload(
            replica_ids=payload.replica_ids,
            keys=tuple(payload.keys[i] for i in kixs),
            vv=payload.vv[rows],
            dot_id=payload.dot_id[rows],
            dot_n=payload.dot_n[rows],
            key_ix=remap[payload.key_ix[rows]].astype(np.int32),
            values=tuple(payload.values[int(r)] for r in rows),
            wall=payload.wall[rows])
    return out


class PackedVersionStore:
    """The resident packed store.  All mutation is numpy; bulk merges hand
    one [N, K, R] tensor to ``core.batched.sync_mask_np`` or the fused CUDA
    kernel (``kernels.dvv_ops.dvv_sync_mask``)."""

    def __init__(self, n_buckets: int = DIGEST_BUCKETS, *,
                 track_digests: bool = True) -> None:
        if n_buckets & (n_buckets - 1):
            raise ValueError("n_buckets must be a power of two")
        self.vv = np.zeros((_INITIAL_SLOTS, _INITIAL_REPLICAS), np.int32)
        self.dot_id = np.full(_INITIAL_SLOTS, NO_DOT, np.int32)
        self.dot_n = np.zeros(_INITIAL_SLOTS, np.int32)
        self.key_ix = np.full(_INITIAL_SLOTS, -1, np.int32)
        self.valid = np.zeros(_INITIAL_SLOTS, bool)
        self.values: List[Any] = [None] * _INITIAL_SLOTS
        self.wall = np.zeros(_INITIAL_SLOTS, np.float64)
        self.n_slots = 0                 # high-water mark
        self.n_dead = 0
        self.replica_ids: List[str] = []
        self._replica_index: Dict[str, int] = {}
        self.keys: List[str] = []
        self._key_index: Dict[str, int] = {}
        self._slots_by_key: Dict[int, List[int]] = {}
        # digest state: canonical per-slot hashes + per-bucket xor-folds and
        # live counts.  track_digests=False skips incremental upkeep (for
        # throwaway staging stores that never serve a delta round);
        # sync_digest()/bucket_counts() then rebuild from content on demand.
        self.n_buckets = n_buckets
        self.track_digests = track_digests
        self.slot_hash = np.zeros(_INITIAL_SLOTS, _U64)
        self.digest = np.zeros(n_buckets, _U64)
        self._bucket_live = np.zeros(n_buckets, np.int64)
        # tree root (xor of all live slot hashes — width-invariant), kept
        # incrementally so the sharded phase-0 probe is one int compare
        self._digest_root = 0
        # value root: xor-fold over live slots of mix(slot_hash ^ value
        # hash) — content equality beyond the clock+key digest (§6.1 covers
        # clocks only; clock-equal/value-different slots are invisible to
        # ``digest`` but flip this root).  Maintained with the digests.
        self.val_hash = np.zeros(_INITIAL_SLOTS, _U64)
        self._value_root = 0
        self._replica_hash: List[int] = []            # aligned with replica_ids
        self._key_hash = np.zeros(_INITIAL_KEYS, _U64)    # aligned with keys
        self._key_bucket = np.zeros(_INITIAL_KEYS, np.int32)
        # bucket → live-slot index (maintained unconditionally — it is what
        # makes payload(key_ranges=...) O(divergent slots) instead of
        # O(store); see DESIGN.md §6.3)
        self._bucket_slots: Dict[int, set] = {}
        # geo tier (DESIGN.md §12): running max over the live wall column
        # (an O(1)-amortized fold of the array max-reduce the stable
        # frontier needs), and an optional displacement hook —
        # ``shadow_hook(key, before_set)`` fires whenever a key's live
        # version set changes away from a non-empty prior set, so the geo
        # plane can retain displaced-but-snapshot-visible versions.
        self.max_wall = 0.0
        self.shadow_hook: Optional[Callable[
            [str, FrozenSet[Version]], None]] = None
        # durability tier (DESIGN.md §14): ``wal_hook(payload)`` fires after
        # every committed mutation with the *post-state* of the changed keys
        # (a per-key PackedPayload).  Store evolution is monotone in the
        # version-set lattice, so replaying these post-states in order
        # reconstructs the exact final sets — the last record per key wins.
        self.wal_hook: Optional[Callable[["PackedPayload"], None]] = None

    # -- interning / growth ------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.replica_ids)

    def intern_replica(self, r: str) -> int:
        ix = self._replica_index.get(r)
        if ix is None:
            ix = len(self.replica_ids)
            self.replica_ids.append(r)
            self._replica_index[r] = ix
            self._replica_hash.append(_hash_str(r))
            if ix >= self.vv.shape[1]:
                grow = max(self.vv.shape[1], 4)
                self.vv = np.pad(self.vv, ((0, 0), (0, grow)))
        return ix

    def intern_key(self, k: str) -> int:
        ix = self._key_index.get(k)
        if ix is None:
            ix = len(self.keys)
            self.keys.append(k)
            self._key_index[k] = ix
            self._slots_by_key[ix] = []
            if ix >= len(self._key_hash):
                grow = len(self._key_hash)
                self._key_hash = np.pad(self._key_hash, (0, grow))
                self._key_bucket = np.pad(self._key_bucket, (0, grow))
            h = _hash_str(k)
            self._key_hash[ix] = h
            self._key_bucket[ix] = h & (self.n_buckets - 1)
        return ix

    def _ensure_capacity(self, extra: int) -> None:
        need = self.n_slots + extra
        cap = self.vv.shape[0]
        if need <= cap:
            return
        new_cap = max(need, 2 * cap)
        pad = new_cap - cap
        self.vv = np.pad(self.vv, ((0, pad), (0, 0)))
        self.dot_id = np.pad(self.dot_id, (0, pad), constant_values=NO_DOT)
        self.dot_n = np.pad(self.dot_n, (0, pad))
        self.key_ix = np.pad(self.key_ix, (0, pad), constant_values=-1)
        self.valid = np.pad(self.valid, (0, pad))
        self.slot_hash = np.pad(self.slot_hash, (0, pad))
        self.val_hash = np.pad(self.val_hash, (0, pad))
        self.wall = np.pad(self.wall, (0, pad))
        self.values.extend([None] * pad)

    def compact(self, *, force: bool = False) -> None:
        """Reclaim dead slots (stable order) when they outnumber live ones.

        Digests are untouched: compaction moves slots without changing the
        live set.  The per-key slot-list remap is one old→new index array
        (per-key lists only ever hold live slots, so every entry remaps).
        """
        live = self.n_slots - self.n_dead   # both counters are maintained
        if not force and self.n_dead <= max(live, _INITIAL_SLOTS):
            return
        keep = np.flatnonzero(self.valid[: self.n_slots])
        n = len(keep)
        self.vv[:n] = self.vv[keep]
        self.dot_id[:n] = self.dot_id[keep]
        self.dot_n[:n] = self.dot_n[keep]
        self.key_ix[:n] = self.key_ix[keep]
        self.slot_hash[:n] = self.slot_hash[keep]
        self.val_hash[:n] = self.val_hash[keep]
        self.wall[:n] = self.wall[keep]
        self.values[:n] = [self.values[s] for s in keep]
        self.valid[:n] = True
        self.valid[n:] = False
        self.key_ix[n:] = -1
        self.values[n:] = [None] * (len(self.values) - n)
        remap = np.full(self.n_slots, -1, np.int64)
        remap[keep] = np.arange(n)
        self.n_slots = n
        self.n_dead = 0
        for kix, slots in self._slots_by_key.items():
            if slots:
                new = remap[np.asarray(slots)]
                # lists must only ever hold live slots (kills prune them);
                # a -1 here means a kill path forgot to, which would
                # corrupt version sets silently downstream — fail loudly.
                assert (new >= 0).all(), (kix, slots)
                self._slots_by_key[kix] = new.tolist()
        # bucket→slot index holds only live slots, so every entry remaps
        self._bucket_slots = {
            b: {int(remap[s]) for s in slots}
            for b, slots in self._bucket_slots.items() if slots}

    # -- slot accessors ----------------------------------------------------

    def key_slots(self, key: str) -> List[int]:
        kix = self._key_index.get(key)
        if kix is None:
            return []
        return self._slots_by_key.get(kix, [])

    def key_clock_arrays(self, key: str
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vv[K, R], dot_id[K], dot_n[K]) for one key — a view-copy slice."""
        slots = self.key_slots(key)
        R = self.n_replicas
        if not slots:
            return (np.zeros((0, R), np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.int32))
        s = np.asarray(slots)
        return self.vv[s, :R], self.dot_id[s], self.dot_n[s]

    def total_keys(self) -> int:
        return sum(1 for slots in self._slots_by_key.values() if slots)

    def total_versions(self) -> int:
        return int(self.valid[: self.n_slots].sum())

    def metadata_size(self, key: str) -> int:
        """Paper's space metric: 2 ints per plain component, 3 per dotted."""
        vv, dot_id, dot_n = self.key_clock_arrays(key)
        if vv.shape[0] == 0:
            return 0
        R = vv.shape[1]
        ar = np.arange(R, dtype=np.int32)
        plain = vv > 0
        dotted = (dot_id[:, None] == ar) & (dot_n[:, None] > 0)
        return int(2 * (plain & ~dotted).sum() + 3 * dotted.sum())

    # -- digest tree (delta anti-entropy, DESIGN.md §6) --------------------

    def _slot_hash_rows(self, vv: np.ndarray, dot_id: np.ndarray,
                        dot_n: np.ndarray, kix: np.ndarray) -> np.ndarray:
        """Canonical 64-bit hash per (clock, key) row, vectorized.

        The hash folds per-replica contributions keyed by the *replica-id
        string hash* (never the column index) with XOR, so it is invariant
        under column permutation, interning order and trailing zero columns
        — two replicas holding the same version of the same key always
        agree, whatever their universes look like.
        """
        vv = np.asarray(vv, np.int64)
        M, R = vv.shape
        rh = np.asarray(self._replica_hash[:R], _U64) if R else \
            np.zeros(0, _U64)
        with np.errstate(over="ignore"):
            if R:
                contrib = _mix64(rh[None, :] ^ (vv.astype(_U64) * _GOLD))
                contrib = np.where(vv > 0, contrib, _U64(0))
                h = np.bitwise_xor.reduce(contrib, axis=1)
            else:
                h = np.zeros(M, _U64)
            has_dot = np.asarray(dot_id) != NO_DOT
            safe = np.clip(dot_id, 0, max(R - 1, 0))
            dot_rh = rh[safe] if R else np.zeros(M, _U64)
            dot_h = _mix64(dot_rh ^ (np.asarray(dot_n, _U64) * _GOLD)
                           ^ _DOT_SALT)
            h ^= np.where(has_dot, dot_h, _U64(0))
            return _mix64(h ^ self._key_hash[np.asarray(kix)])

    def _digest_kill(self, slots: np.ndarray) -> None:
        """Remove ``slots`` from their buckets (xor out + live-count down)."""
        if not self.track_digests or not len(slots):
            return
        s = np.asarray(slots)
        b = self._key_bucket[self.key_ix[s]]
        np.bitwise_xor.at(self.digest, b, self.slot_hash[s])
        np.subtract.at(self._bucket_live, b, 1)
        self._digest_root ^= int(np.bitwise_xor.reduce(self.slot_hash[s]))
        self._value_root ^= int(np.bitwise_xor.reduce(
            _mix64(self.slot_hash[s] ^ self.val_hash[s])))

    def sync_digest(self) -> StoreDigest:
        """Snapshot the digest tree — phase 1 of a delta round.

        On a ``track_digests=False`` store this rebuilds from content first
        (O(live); such stores are staging scratch, not protocol peers)."""
        if not self.track_digests:
            self.rebuild_digests()
        return StoreDigest(self.digest.copy())

    def digest_root(self) -> int:
        """The tree root alone — the xor of all leaves, maintained
        incrementally.  The phase-0 probe of a sharded delta round: two
        stores whose roots (and value roots) agree are skipped for the
        cost of 16 bytes, without snapshotting either tree."""
        if not self.track_digests:
            self.rebuild_digests()
        return self._digest_root

    def value_root(self) -> int:
        """64-bit root of the store's *value content* (clock+key+value),
        maintained incrementally beside the digest tree.  Equal stores
        always agree; clock-equal/value-different slots — impossible under
        the protocol (a clock names one write), possible in stores fed
        arbitrary ``bulk_sync`` dicts — disagree here while the §6.1 clock
        digests collide, which is what routes delta rounds to the
        full-round fallback (DESIGN.md §6.1)."""
        if not self.track_digests:
            self.rebuild_digests()
        return self._value_root

    def bucket_counts(self, width: Optional[int] = None) -> np.ndarray:
        """Live slots per bucket at ``width`` (default: this store's) — the
        ranking signal for divergent-range requests (big ranges first).
        Maintained incrementally alongside the digests, so a delta round's
        ranking never sweeps the slot arrays."""
        width = width or self.n_buckets
        if not self.track_digests:
            live = self.valid[: self.n_slots]
            b = self._key_bucket[self.key_ix[: self.n_slots]] & (width - 1)
            return np.bincount(b[live], minlength=width)
        if width == self.n_buckets:
            return self._bucket_live.copy()
        return self._bucket_live.reshape(-1, width).sum(axis=0)

    def _maybe_grow_buckets(self) -> None:
        """Keep ~``_SLOTS_PER_BUCKET`` live slots per leaf: widen the tree
        as the store grows so delta-round granularity tracks store size.
        The O(live) digest rebuild amortizes over the inserts that
        triggered it; peers at the old width still diff via folding."""
        live = self.n_slots - self.n_dead
        grew = False
        while (live > self.n_buckets * _SLOTS_PER_BUCKET
               and self.n_buckets < _MAX_BUCKETS):
            self.n_buckets *= _BUCKET_GROWTH
            grew = True
        if grew:
            n = len(self.keys)
            self._key_bucket[:n] = (
                self._key_hash[:n] & _U64(self.n_buckets - 1)).astype(np.int32)
            self._rebuild_bucket_index()
            if self.track_digests:
                # width growth: slot/value hashes are width-invariant and
                # incrementally maintained — only re-bucket them
                self.rebuild_digests(values_too=False)

    def _rebuild_bucket_index(self) -> None:
        """Recompute the bucket→slot index from slot content (O(live))."""
        self._bucket_slots = {}
        live = np.flatnonzero(self.valid[: self.n_slots])
        buckets = self._key_bucket[self.key_ix[live]]
        for s, b in zip(live.tolist(), buckets.tolist()):
            self._bucket_slots.setdefault(int(b), set()).add(int(s))

    def check_bucket_index(self) -> bool:
        """True iff the incremental bucket→slot index matches a full scan."""
        live = np.flatnonzero(self.valid[: self.n_slots])
        buckets = self._key_bucket[self.key_ix[live]]
        expect: Dict[int, set] = {}
        for s, b in zip(live.tolist(), buckets.tolist()):
            expect.setdefault(int(b), set()).add(int(s))
        got = {b: set(v) for b, v in self._bucket_slots.items() if v}
        return expect == got

    def rebuild_digests(self, *, values_too: bool = True) -> np.ndarray:
        """Recompute buckets and live counts from slot content (in place).

        The incremental state must always equal this recomputation —
        ``check_digests`` asserts it in tests; calling this repairs a store
        whose digest state was corrupted (e.g. the collision probe).
        ``values_too=False`` trusts the incrementally-maintained per-slot
        value hashes (the bucket-width growth path: neither slot hashes
        nor value hashes depend on the width, but the per-value rehash is
        an O(live) Python loop worth skipping there).
        """
        live = np.flatnonzero(self.valid[: self.n_slots])
        R = self.n_replicas
        self.digest = np.zeros(self.n_buckets, _U64)
        self._bucket_live = np.zeros(self.n_buckets, np.int64)
        self._digest_root = 0
        self._value_root = 0
        if len(live):
            kixs = self.key_ix[live]
            hashes = self._slot_hash_rows(
                self.vv[live, :R], self.dot_id[live], self.dot_n[live], kixs)
            self.slot_hash[live] = hashes
            buckets = self._key_bucket[kixs]
            np.bitwise_xor.at(self.digest, buckets, hashes)
            np.add.at(self._bucket_live, buckets, 1)
            if values_too:
                self.val_hash[live] = np.asarray(
                    [_hash_value(self.values[int(s)]) for s in live], _U64)
            self._digest_root = int(np.bitwise_xor.reduce(hashes))
            self._value_root = int(np.bitwise_xor.reduce(
                _mix64(hashes ^ self.val_hash[live])))
        return self.digest

    def check_digests(self) -> bool:
        """True iff the incremental digest state matches a full recompute."""
        if not self.check_bucket_index():
            return False
        saved = (self.digest, self.slot_hash.copy(), self._bucket_live,
                 self.val_hash.copy(), self._value_root, self._digest_root)
        try:
            rebuilt = self.rebuild_digests()
            return (np.array_equal(rebuilt, saved[0])
                    and np.array_equal(self._bucket_live, saved[2])
                    and self._value_root == saved[4]
                    and self._digest_root == saved[5])
        finally:
            (self.digest, self.slot_hash, self._bucket_live,
             self.val_hash, self._value_root, self._digest_root) = saved

    # -- boundary codec (object clocks at the client API edge only) --------

    def encode_clock(self, clock: DVV) -> Tuple[np.ndarray, int, int]:
        """Encode one object clock into *this store's* universe (growing it)."""
        for r in clock.ids():
            self.intern_replica(r)
        R = self.n_replicas
        vv = np.zeros(R, np.int32)
        dot_id, dot_n = NO_DOT, 0
        for (r, m, n) in clock.components:
            col = self._replica_index[r]
            vv[col] = m
            if n:
                if dot_id != NO_DOT:
                    raise ValueError("packed store supports at most one dot")
                dot_id, dot_n = col, n
        return vv, dot_id, dot_n

    def decode_slot(self, slot: int) -> DVV:
        vv = self.vv[slot]
        return B.decode(vv[: self.n_replicas], int(self.dot_id[slot]),
                        int(self.dot_n[slot]), self.replica_ids)

    def versions(self, key: str) -> FrozenSet[Version]:
        """Client-edge decode of one key's live versions."""
        return frozenset(
            Version(self.decode_slot(s), self.values[s],
                    wall=float(self.wall[s]))
            for s in self.key_slots(key))

    def context_of(self, key: str) -> CausalContext:
        """The GET context token for one key, straight from the int32
        columns: per-replica ceiling ⌈S⌉ (max of ranges and dots) over the
        key's live slots.  Zero object-clock decodes — this is the packed
        backend's §5.4 compaction, O(siblings·R) integer max, O(R) output.
        """
        slots = self.key_slots(key)
        if not slots:
            return CausalContext()
        s = np.asarray(slots)
        R = self.n_replicas
        ceil = ceiling_from_rows(self.vv[s, :R], self.dot_id[s],
                                 self.dot_n[s])
        return CausalContext(entries=tuple(sorted(
            (self.replica_ids[c], int(ceil[c]))
            for c in range(R) if ceil[c] > 0)))

    def ceiling_of_entries(self, entries: Iterable[Tuple[str, int]]
                           ) -> np.ndarray:
        """A token's ceiling entries as a vv row in local columns (growing
        the universe for unseen replica ids).  The token-native twin of
        ``context_ceiling`` — no clock objects anywhere."""
        items = list(entries)
        for rid, _ in items:
            self.intern_replica(rid)
        vv = np.zeros(self.n_replicas, np.int32)
        for rid, n in items:
            col = self._replica_index[rid]
            vv[col] = max(vv[col], n)
        return vv

    # -- per-key mutation (control plane: PUT / replication messages) ------

    def _insert_slot(self, kix: int, vv: np.ndarray, dot_id: int, dot_n: int,
                     value: Any, wall: float = 0.0) -> int:
        self._ensure_capacity(1)
        s = self.n_slots
        self.vv[s, : len(vv)] = vv
        self.vv[s, len(vv):] = 0
        self.dot_id[s] = dot_id
        self.dot_n[s] = dot_n
        self.key_ix[s] = kix
        self.valid[s] = True
        self.values[s] = value
        self.wall[s] = wall
        if wall > self.max_wall:
            self.max_wall = wall
        self.n_slots += 1
        self._slots_by_key.setdefault(kix, []).append(s)
        bucket = int(self._key_bucket[kix])
        self._bucket_slots.setdefault(bucket, set()).add(s)
        if self.track_digests:
            R = self.n_replicas
            self.slot_hash[s] = self._slot_hash_rows(
                self.vv[s: s + 1, :R], self.dot_id[s: s + 1],
                self.dot_n[s: s + 1], self.key_ix[s: s + 1])[0]
            self.digest[bucket] ^= self.slot_hash[s]
            self._bucket_live[bucket] += 1
            self._digest_root ^= int(self.slot_hash[s])
            self.val_hash[s] = _U64(_hash_value(value))
            self._value_root ^= int(_mix64(self.slot_hash[s]
                                           ^ self.val_hash[s]))
        return s

    def _index_kill(self, slots: np.ndarray) -> None:
        """Drop ``slots`` from the bucket→slot index (before valid flips)."""
        buckets = self._key_bucket[self.key_ix[np.asarray(slots)]]
        for s, b in zip(np.asarray(slots).tolist(), buckets.tolist()):
            self._bucket_slots[int(b)].discard(int(s))

    def _kill_slots(self, kix: int, dead: Sequence[int]) -> None:
        if not len(dead):
            return
        self._digest_kill(np.asarray(dead))
        self._index_kill(np.asarray(dead))
        self.valid[np.asarray(dead)] = False
        self.n_dead += len(dead)
        deadset = set(int(d) for d in dead)
        self._slots_by_key[kix] = [
            s for s in self._slots_by_key[kix] if s not in deadset]

    def sync_key(self, key: str, inc_vv: np.ndarray, inc_dot_id: np.ndarray,
                 inc_dot_n: np.ndarray, inc_values: Sequence[Any],
                 inc_walls: Optional[Sequence[float]] = None) -> bool:
        """Merge incoming clocks (already in local columns) into one key.

        Pure numpy — the per-key path taken by PUT and replication-message
        delivery.  Local slots are listed first so duplicates keep the
        resident copy.  Returns True iff the key's version set changed.
        """
        kix = self.intern_key(key)
        slots = self._slots_by_key.get(kix, [])
        R = self.n_replicas
        L, M = len(slots), int(inc_vv.shape[0])
        if M == 0:
            return False
        before = self.versions(key) if self.shadow_hook is not None else None
        K = L + M
        vvs = np.zeros((K, R), np.int32)
        dids = np.full(K, NO_DOT, np.int32)
        dns = np.zeros(K, np.int32)
        if L:
            s = np.asarray(slots)
            vvs[:L] = self.vv[s, :R]
            dids[:L] = self.dot_id[s]
            dns[:L] = self.dot_n[s]
        vvs[L:, : inc_vv.shape[1]] = inc_vv
        dids[L:] = inc_dot_id
        dns[L:] = inc_dot_n

        mask = B.sync_mask_np(vvs, dids, dns, np.ones(K, bool))
        changed = False
        dead = [slots[j] for j in range(L) if not mask[j]]
        if dead:
            self._kill_slots(kix, dead)
            changed = True
        for j in range(M):
            if mask[L + j]:
                self._insert_slot(
                    kix, inc_vv[j], int(inc_dot_id[j]), int(inc_dot_n[j]),
                    inc_values[j],
                    wall=float(inc_walls[j]) if inc_walls is not None
                    else 0.0)
                changed = True
        if changed and before:
            self.shadow_hook(key, before)
        self.compact()
        self._maybe_grow_buckets()
        if changed and self.wal_hook is not None:
            self.wal_hook(self.payload(keys=(key,)))
        return changed

    def sync_key_objects(self, key: str, versions: Iterable[Version]) -> bool:
        """Boundary codec + merge for object versions reaching one key (the
        control-plane path: replication messages, object-payload staging).

        The deterministic (repr(clock), repr(value)) ordering decides
        duplicate-clock tie-breaks; keep it in this one place.
        """
        ordered = sorted(versions,
                         key=lambda v: (repr(v.clock), repr(v.value)))
        if not ordered:
            self.intern_key(key)
            return False
        rows = [self.encode_clock(v.clock) for v in ordered]
        R = self.n_replicas
        vv = np.zeros((len(rows), R), np.int32)
        for i, (row_vv, _, _) in enumerate(rows):
            vv[i, : len(row_vv)] = row_vv
        return self.sync_key(
            key, vv, np.asarray([r[1] for r in rows], np.int32),
            np.asarray([r[2] for r in rows], np.int32),
            [v.value for v in ordered], [v.wall for v in ordered])

    def update_key(self, key: str, ctx_vv: np.ndarray, coordinator: str,
                   value: Any, wall: float = 0.0
                   ) -> Tuple[np.ndarray, int, int]:
        """Paper §5.3 update, entirely in arrays.

        ``ctx_vv`` is the context ceiling ⌈S⌉ already in local columns
        (length ≤ R; zero-padded).  Mints the new clock with the dot at the
        coordinator, syncs it into the key, returns the new clock arrays.
        """
        r_ix = self.intern_replica(coordinator)
        R = self.n_replicas
        vv = np.zeros(R, np.int32)
        vv[: len(ctx_vv)] = ctx_vv
        lvv, ldid, ldn = self.key_clock_arrays(key)
        local_max = B.effective_ceil_np(lvv, ldid, ldn, r_ix) \
            if lvv.shape[0] else 0
        # Mirrors core.dvv.update: m = ⌈S⌉_r from the context, n = ⌈Sr⌉_r + 1.
        # The §5.4 invariant guarantees n > m (all r-events are known at r).
        dot_n = local_max + 1
        self.sync_key(key, vv[None, :], np.asarray([r_ix], np.int32),
                      np.asarray([dot_n], np.int32), [value], [wall])
        return vv, r_ix, dot_n

    def update_keys(self, updates: Sequence[Tuple[str, Iterable[Tuple[str,
                    int]], Any, float]], coordinator: str, *,
                    mask_fn=None) -> Tuple[np.ndarray, int, np.ndarray]:
        """Batched §5.3 update: mint one clock per key, then merge all of
        them with ONE grouped ``apply_payload`` pass (one scatter, one
        ``sync_mask`` evaluation — optionally the shape-bucketed CUDA
        kernel via ``mask_fn``) instead of K independent ``sync_key`` walks.

        ``updates`` is ``[(key, ceiling_entries, value, wall), ...]`` with
        *distinct* keys (a batch is a set of independent writes; two writes
        to one key have a client-side causal order and must be two calls).
        Returns ``(vv[M, R], r_ix, dot_n[M])`` for the minted clocks,
        aligned with ``updates``.
        """
        keys = [u[0] for u in updates]
        if len(set(keys)) != len(keys):
            raise ValueError("update_keys requires distinct keys per batch")
        r_ix = self.intern_replica(coordinator)
        for _, entries, _, _ in updates:
            for rid, _ in entries:
                self.intern_replica(rid)
        R = self.n_replicas
        M = len(updates)
        vv = np.zeros((M, R), np.int32)
        for i, (_, entries, _, _) in enumerate(updates):
            row = self.ceiling_of_entries(entries)   # universe pre-grown
            vv[i, : len(row)] = row
        # ⌈Sr⌉_r per key over the resident slots, one grouped scatter.
        kixs = [self.intern_key(k) for k in keys]
        lists = [self._slots_by_key.get(kx, []) for kx in kixs]
        loc_rows = np.asarray([s for l in lists for s in l], np.int64)
        loc_group = np.repeat(np.arange(M), [len(l) for l in lists])
        local_max = B.grouped_ceil_at_np(
            self.vv[loc_rows, r_ix], self.dot_id[loc_rows],
            self.dot_n[loc_rows], loc_group, M, r_ix)
        dot_n = (local_max + 1).astype(np.int32)
        minted = PackedPayload(
            replica_ids=tuple(self.replica_ids),
            keys=tuple(keys),
            vv=vv,
            dot_id=np.full(M, r_ix, np.int32),
            dot_n=dot_n,
            key_ix=np.arange(M, dtype=np.int32),
            values=tuple(u[2] for u in updates),
            wall=np.asarray([u[3] for u in updates], np.float64))
        self.apply_payload(minted, mask_fn=mask_fn)
        return vv, r_ix, dot_n

    def context_ceiling(self, context: Iterable[DVV]) -> np.ndarray:
        """⌈S⌉ of a client context (object clocks — the API edge), in local
        columns, growing the universe for unseen replica ids."""
        clocks = list(context)
        for c in clocks:
            for r in c.ids():
                self.intern_replica(r)
        vv = np.zeros(self.n_replicas, np.int32)
        for c in clocks:
            for (r, m, n) in c.components:
                col = self._replica_index[r]
                vv[col] = max(vv[col], m, n)
        return vv

    # -- bulk anti-entropy (the hot path: arrays in, arrays out) -----------

    def payload(self, keys: Optional[Iterable[str]] = None, *,
                key_ranges: Optional[Sequence[int]] = None,
                ranges_width: Optional[int] = None) -> PackedPayload:
        """Extract the live slots for ``keys`` (default: all) as one payload.

        ``key_ranges`` selects by digest bucket instead: only live slots
        whose key hashes into one of the given buckets are shipped — the
        phase-2 slice of a delta round, gathered from the incremental
        bucket→slot index in O(selected slots), not O(store).
        ``ranges_width`` interprets the bucket ids at a narrower
        power-of-two width (a peer with a smaller tree; must divide this
        store's width).  Pure array slicing — zero object decode either
        way.
        """
        R = self.n_replicas
        if keys is not None and key_ranges is not None:
            raise ValueError("pass keys or key_ranges, not both")
        if key_ranges is not None:
            width = ranges_width or self.n_buckets
            if width > self.n_buckets or self.n_buckets % width:
                raise ValueError(
                    f"ranges_width {width} incompatible with "
                    f"{self.n_buckets} buckets")
            # A narrow bucket ``b`` at ``width`` is the fold of the local
            # buckets {b + j·width}; union their slot sets from the index.
            cand: List[int] = []
            for b in key_ranges:
                for j in range(self.n_buckets // width):
                    slots = self._bucket_slots.get(int(b) + j * width)
                    if slots:
                        cand.extend(slots)
            rows = np.asarray(sorted(cand), dtype=np.int64)
            uniq, inv = np.unique(self.key_ix[rows], return_inverse=True) \
                if len(rows) else (np.zeros(0, np.int64), np.zeros(0,
                                                                   np.int64))
            sel_keys = [self.keys[int(kx)] for kx in uniq]
            out_kix = inv.astype(np.int32)
        elif keys is None:
            rows = np.flatnonzero(self.valid[: self.n_slots])
            kixs = self.key_ix[rows]
            sel_keys = self.keys
            out_kix = kixs.astype(np.int32)
        else:
            want = [self._key_index[k] for k in keys if k in self._key_index]
            sel_keys = [self.keys[kx] for kx in want]
            rows_l: List[int] = []
            out_l: List[int] = []
            for out_ix, kx in enumerate(want):
                for s in self._slots_by_key.get(kx, []):
                    rows_l.append(s)
                    out_l.append(out_ix)
            rows = np.asarray(rows_l, dtype=np.int64)
            out_kix = np.asarray(out_l, dtype=np.int32)
        if len(rows) == 0:
            return PackedPayload(tuple(self.replica_ids), tuple(sel_keys),
                                 np.zeros((0, R), np.int32),
                                 np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0, np.int32), ())
        return PackedPayload(
            replica_ids=tuple(self.replica_ids),
            keys=tuple(sel_keys),
            vv=self.vv[rows, :R].copy(),
            dot_id=self.dot_id[rows].copy(),
            dot_n=self.dot_n[rows].copy(),
            key_ix=out_kix,
            values=tuple(self.values[int(s)] for s in rows),
            wall=self.wall[rows].copy(),
        )

    def _remap_columns(self, payload: PackedPayload
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Map payload columns into the local universe with one gather."""
        col_map = np.asarray(
            [self.intern_replica(r) for r in payload.replica_ids], np.int64)
        return remap_rows(payload.vv, payload.dot_id, col_map,
                          self.n_replicas)

    def apply_payload(self, payload: PackedPayload, *,
                      mask_fn=None) -> int:
        """One anti-entropy round: remap → group → sync_mask → write-back.

        ``mask_fn(vvs[N, K, R], dot_ids[N, K], dot_ns[N, K], valid[N, K])
        -> bool[N, K]`` defaults to the numpy reference twin of
        ``core.batched.sync_mask``; pass ``kernels.dvv_ops.
        dvv_sync_mask_bucketed(device)`` for the fused CUDA kernel.  Returns the number of keys whose
        version set changed.

        Fully vectorized: grouping is one stable sort + two fancy-index
        scatters; write-back is one masked kill + one bulk append.  No
        per-key DVV objects, no per-key numpy calls.
        """
        M = len(payload)
        if M == 0:
            return 0
        inc_vv, inc_did = self._remap_columns(payload)
        inc_dn = payload.dot_n
        # Collapse duplicate payload keys to one group each (a caller can
        # legitimately request the same key twice, e.g. antientropy with a
        # repeated key list); two groups for one key would double-insert.
        key_ixs_all = np.asarray(
            [self.intern_key(k) for k in payload.keys], np.int64)
        key_ixs, inverse = np.unique(key_ixs_all, return_inverse=True)
        R = self.n_replicas
        N = len(key_ixs)
        before_sets = None
        if self.shadow_hook is not None:
            before_sets = [self.versions(self.keys[int(kx)])
                           for kx in key_ixs]

        # One group per payload key; local resident slots occupy the first
        # positions (duplicates keep the resident copy), incoming rows
        # follow in payload order.
        local_lists = [self._slots_by_key.get(int(kx), []) for kx in key_ixs]
        loc_counts = np.asarray([len(l) for l in local_lists], np.int64)
        loc_rows = np.asarray(
            [s for l in local_lists for s in l], dtype=np.int64)
        loc_group = np.repeat(np.arange(N), loc_counts)
        loc_start = np.zeros(N + 1, np.int64)
        np.cumsum(loc_counts, out=loc_start[1:])
        loc_pos = np.arange(len(loc_rows)) - loc_start[loc_group]

        inc_group = inverse[payload.key_ix]
        order = np.argsort(inc_group, kind="stable")
        sorted_g = inc_group[order]
        run_start = np.searchsorted(sorted_g, np.arange(N))
        inc_pos = np.empty(M, np.int64)
        inc_pos[order] = np.arange(M) - run_start[sorted_g]
        inc_pos += loc_counts[inc_group]

        counts = loc_counts + np.bincount(inc_group, minlength=N)
        K = int(counts.max(initial=1))
        vvs = np.zeros((N, K, R), np.int32)
        dids = np.full((N, K), NO_DOT, np.int32)
        dns = np.zeros((N, K), np.int32)
        valid = np.zeros((N, K), bool)
        if len(loc_rows):
            vvs[loc_group, loc_pos] = self.vv[loc_rows, :R]
            dids[loc_group, loc_pos] = self.dot_id[loc_rows]
            dns[loc_group, loc_pos] = self.dot_n[loc_rows]
            valid[loc_group, loc_pos] = True
        vvs[inc_group, inc_pos] = inc_vv
        dids[inc_group, inc_pos] = inc_did
        dns[inc_group, inc_pos] = inc_dn
        valid[inc_group, inc_pos] = True

        if mask_fn is None:
            mask = B.sync_mask_np(vvs, dids, dns, valid)
        else:
            mask = np.asarray(mask_fn(vvs, dids, dns, valid))

        # -- write-back: masked kill of local slots ------------------------
        changed_groups = np.zeros(N, bool)
        if len(loc_rows):
            loc_keep = mask[loc_group, loc_pos]
            dead_rows = loc_rows[~loc_keep]
            if len(dead_rows):
                self._digest_kill(dead_rows)
                self._index_kill(dead_rows)
                self.valid[dead_rows] = False
                self.n_dead += len(dead_rows)
                dead_set = set(dead_rows.tolist())
                for g in np.unique(loc_group[~loc_keep]):
                    kix = int(key_ixs[g])
                    self._slots_by_key[kix] = [
                        s for s in self._slots_by_key[kix]
                        if s not in dead_set]
                changed_groups[loc_group[~loc_keep]] = True

        # -- write-back: bulk append of surviving incoming rows ------------
        new_rows = np.flatnonzero(mask[inc_group, inc_pos])
        n_new = len(new_rows)
        if n_new:
            self._ensure_capacity(n_new)
            s0 = self.n_slots
            dst = s0 + np.arange(n_new)
            self.vv[dst, :R] = inc_vv[new_rows]
            self.vv[dst, R:] = 0
            self.dot_id[dst] = inc_did[new_rows]
            self.dot_n[dst] = inc_dn[new_rows]
            self.wall[dst] = payload.wall[new_rows]
            new_max = float(payload.wall[new_rows].max())
            if new_max > self.max_wall:
                self.max_wall = new_max
            groups_new = inc_group[new_rows]
            kix_new = key_ixs[groups_new]
            self.key_ix[dst] = kix_new
            self.valid[dst] = True
            new_buckets = self._key_bucket[kix_new]
            if self.track_digests:
                new_hashes = self._slot_hash_rows(
                    inc_vv[new_rows], inc_did[new_rows], inc_dn[new_rows],
                    kix_new)
                self.slot_hash[dst] = new_hashes
                np.bitwise_xor.at(self.digest, new_buckets, new_hashes)
                np.add.at(self._bucket_live, new_buckets, 1)
                self._digest_root ^= int(np.bitwise_xor.reduce(new_hashes))
                vhs = np.asarray([_hash_value(payload.values[int(r)])
                                  for r in new_rows], _U64)
                self.val_hash[dst] = vhs
                self._value_root ^= int(np.bitwise_xor.reduce(
                    _mix64(new_hashes ^ vhs)))
            for i, row in enumerate(new_rows):
                self.values[s0 + i] = payload.values[int(row)]
                self._slots_by_key[int(kix_new[i])].append(s0 + i)
                self._bucket_slots.setdefault(
                    int(new_buckets[i]), set()).add(s0 + i)
            self.n_slots += n_new
            changed_groups[groups_new] = True

        if before_sets is not None:
            for g in np.flatnonzero(changed_groups):
                bs = before_sets[int(g)]
                if bs:
                    self.shadow_hook(self.keys[int(key_ixs[int(g)])], bs)
        self.compact()
        self._maybe_grow_buckets()
        if self.wal_hook is not None and changed_groups.any():
            changed_keys = [self.keys[int(key_ixs[int(g)])]
                            for g in np.flatnonzero(changed_groups)]
            self.wal_hook(self.payload(keys=changed_keys))
        return int(changed_groups.sum())

    # -- state carried across packages --------------------------------------

    #: The fields of ``to_arrays``/``from_arrays``: exactly a payload's.
    ARRAY_FIELDS = ("replica_ids", "keys", "vv", "dot_id", "dot_n",
                    "key_ix", "values", "wall")

    def to_arrays(self) -> Dict[str, Any]:
        """The store's live state as plain arrays and tuples: the fields of
        ``payload()`` (every interned key and replica, every live slot)."""
        p = self.payload()
        return {f: getattr(p, f) for f in self.ARRAY_FIELDS}

    @classmethod
    def from_arrays(cls, d: Mapping[str, Any], *,
                    n_buckets: int = DIGEST_BUCKETS) -> "PackedVersionStore":
        """A store holding the state ``d`` describes (the ``to_arrays``
        fields, e.g. read from another implementation's ``payload()``).
        The interning tables keep ``d``'s order and the live slots its row
        order; digests are rebuilt from content, so equal state gives equal
        ``digest_root``/``value_root``."""
        store = cls(n_buckets=n_buckets)
        store.apply_payload(PackedPayload(
            replica_ids=tuple(d["replica_ids"]), keys=tuple(d["keys"]),
            vv=np.asarray(d["vv"], np.int32),
            dot_id=np.asarray(d["dot_id"], np.int32),
            dot_n=np.asarray(d["dot_n"], np.int32),
            key_ix=np.asarray(d["key_ix"], np.int32),
            values=tuple(d["values"]),
            wall=np.asarray(d["wall"], np.float64)))
        for r in d["replica_ids"]:       # an empty payload interns nothing
            store.intern_replica(r)
        for k in d["keys"]:
            store.intern_key(k)
        return store

    # -- misc ---------------------------------------------------------------

    def clone(self) -> "PackedVersionStore":
        out = PackedVersionStore(n_buckets=self.n_buckets,
                                 track_digests=self.track_digests)
        out.vv = self.vv.copy()
        out.dot_id = self.dot_id.copy()
        out.dot_n = self.dot_n.copy()
        out.key_ix = self.key_ix.copy()
        out.valid = self.valid.copy()
        out.values = list(self.values)
        out.wall = self.wall.copy()
        out.max_wall = self.max_wall
        out.n_slots = self.n_slots
        out.n_dead = self.n_dead
        out.replica_ids = list(self.replica_ids)
        out._replica_index = dict(self._replica_index)
        out.keys = list(self.keys)
        out._key_index = dict(self._key_index)
        out._slots_by_key = {k: list(v) for k, v in self._slots_by_key.items()}
        out.slot_hash = self.slot_hash.copy()
        out.val_hash = self.val_hash.copy()
        out._value_root = self._value_root
        out._digest_root = self._digest_root
        out.digest = self.digest.copy()
        out._bucket_live = self._bucket_live.copy()
        out._replica_hash = list(self._replica_hash)
        out._key_hash = self._key_hash.copy()
        out._key_bucket = self._key_bucket.copy()
        out._bucket_slots = {b: set(v) for b, v in self._bucket_slots.items()}
        return out

    def __repr__(self) -> str:
        return (f"<PackedVersionStore keys={self.total_keys()} "
                f"versions={self.total_versions()} R={self.n_replicas}>")


# ---------------------------------------------------------------------------
# Quorum GET merge — arrays across stores, zero object-clock decodes.
# ---------------------------------------------------------------------------

def _clock_key(vv_row: Sequence[int], dot_col: int, dot_n: int,
               sorted_cols: Sequence[Tuple[str, int]]) -> str:
    """Canonical clock string from plain ints + a pre-sorted (rid, col)
    table — the inner loop of the batched read plane (the table is built
    once per quorum group, not once per row)."""
    parts = []
    for rid, col in sorted_cols:
        m = vv_row[col]
        n = dot_n if col == dot_col else 0
        if m or n:
            parts.append(f"({rid},{m})" if n == 0 else f"({rid},{m},{n})")
    return "{" + ", ".join(parts) + "}"


def _clock_sort_key(vv_row: np.ndarray, dot_col: int, dot_n: int,
                    ids: Sequence[str]) -> str:
    """A canonical string for one packed clock, equal by construction to
    ``repr(B.decode(...))`` — the resolution tie-break of GetResult.value,
    produced without building a DVV object."""
    return _clock_key([int(x) for x in vv_row], int(dot_col), int(dot_n),
                      sorted((ids[c], c) for c in range(len(ids))))


@dataclass
class MergedRead:
    """One key's merged quorum read, straight from the int32 columns.

    ``values``/``walls``/``clock_keys`` are row-aligned with the surviving
    clock rows ``vv``/``dot_id``/``dot_n`` (columns follow ``replica_ids``,
    the union universe of the key's quorum group); ``entries`` is the §5.4
    context ceiling of the survivors.  ``stale`` lists the indices — into
    the key's store list as passed to ``quorum_merge_many`` — of quorum
    members whose live row set for the key differs from the survivors
    (row identity = clock + value content): they are missing a surviving
    version, holding a dominated one, or carrying a divergent value under
    an equal clock.  That is the read-repair signal
    (``KVCluster.get_many(repair=True)``).
    """

    replica_ids: Tuple[str, ...]
    vv: np.ndarray          # int32[S, Ru] surviving rows
    dot_id: np.ndarray      # int32[S]
    dot_n: np.ndarray       # int32[S]
    values: List[Any]
    walls: List[float]
    clock_keys: List[str]
    entries: Tuple[Tuple[str, int], ...]
    stale: Tuple[int, ...] = ()


def quorum_merge_many(stores_by_key: Mapping[str,
                                             Sequence[PackedVersionStore]],
                      keys: Sequence[str], *,
                      mask_fn=None, sweep_fn=None,
                      track_stale: bool = True) -> Dict[str, "MergedRead"]:
    """Merge many keys' version sets across their read quorums in one sweep.

    The whole §4 read path, batched: keys are grouped by quorum set (the
    identity tuple of their contacted stores); per group, every store's
    slots for *all* group keys are remapped into one union replica universe
    with a single gather per store (the replica-id→union-column map is
    built once per store, not rebuilt per key), all rows are stacked into
    one grouped ``[N, K, R]`` tensor, survival is evaluated with a single
    ``sync_mask`` sweep (``mask_fn`` routes it through the §6.4 shape
    buckets — ``core.batched.BucketedSyncMask`` or ``kernels.dvv_ops.
    dvv_sync_mask_bucketed(device)``; ``None`` is the numpy reference), and the
    per-key §5.4 ceilings come from one ``grouped_ceiling_np`` segment
    reduce.  ``sweep_fn`` (wins over ``mask_fn``) fuses both steps on
    device — a ``(vvs, dids, dns, valid) → (mask, ceil)`` callable like
    ``kernels.dvv_ops.dvv_read_sweep_bucketed(device)``, the path
    ``use_kernel=True`` reads take.  No ``DVV`` object is created
    anywhere.

    Returns ``{key: MergedRead}`` — survivors plus the per-member staleness
    signal read-repair consumes (``track_stale=False`` skips that
    bookkeeping for pure reads).  Staleness is *content*-aware: row
    identity includes the value repr, so the clock-equal/value-different
    state (impossible under the protocol, reachable via non-protocol
    ``bulk_sync`` feeds — the §6.1 value-root gap) is flagged rather than
    silently reported converged, mirroring the delta round's fallback
    stance; like that fallback, sync itself cannot reconcile equal-clock
    values (the resident copy wins).  Byte-identical to the per-key
    ``quorum_merge_key`` (which is now a one-key wrapper over this).
    """
    out: Dict[str, MergedRead] = {}
    groups: Dict[Tuple[int, ...], List[str]] = {}
    for k in keys:
        groups.setdefault(
            tuple(id(st) for st in stores_by_key[k]), []).append(k)
    for gkeys in groups.values():
        stores = list(stores_by_key[gkeys[0]])
        N = len(gkeys)
        # Union replica universe + per-store column maps, built ONCE per
        # group — the per-key rebuild was the looped read path's tax.
        ids: List[str] = []
        index: Dict[str, int] = {}
        col_maps: List[np.ndarray] = []
        for st in stores:
            cols = np.empty(st.n_replicas, np.int64)
            for j, rid in enumerate(st.replica_ids):
                ix = index.get(rid)
                if ix is None:
                    ix = index[rid] = len(ids)
                    ids.append(rid)
                cols[j] = ix
            col_maps.append(cols)
        Ru = len(ids)
        # One gather per store: all of its rows for all group keys at once.
        chunk_vv, chunk_did, chunk_dn, chunk_wall = [], [], [], []
        chunk_group, chunk_src = [], []
        values: List[Any] = []
        for j, (st, cols) in enumerate(zip(stores, col_maps)):
            lists = [st.key_slots(k) for k in gkeys]
            rows = np.asarray([s for l in lists for s in l], np.int64)
            if not len(rows):
                continue
            cv, cdid = remap_rows(st.vv[rows, : st.n_replicas],
                                  st.dot_id[rows], cols, Ru)
            chunk_vv.append(cv)
            chunk_did.append(cdid)
            chunk_dn.append(st.dot_n[rows])
            chunk_wall.append(st.wall[rows])
            chunk_group.append(
                np.repeat(np.arange(N), [len(l) for l in lists]))
            chunk_src.append(np.full(len(rows), j, np.int64))
            values.extend(st.values[int(s)] for s in rows)
        if not chunk_vv:                      # no store holds any group key
            for key in gkeys:
                out[key] = MergedRead(tuple(ids), np.zeros((0, Ru), np.int32),
                                      np.zeros(0, np.int32),
                                      np.zeros(0, np.int32), [], [], [], ())
            continue
        vv = np.concatenate(chunk_vv)
        did = np.concatenate(chunk_did)
        dn = np.concatenate(chunk_dn)
        wall = np.concatenate(chunk_wall)
        group = np.concatenate(chunk_group)
        src = np.concatenate(chunk_src)
        # Stable sort by key: within a key, rows stay store-major in slot
        # order — the same duplicate tie-break as the per-key merge.
        order = np.argsort(group, kind="stable")
        vv, did, dn, wall = vv[order], did[order], dn[order], wall[order]
        group, src = group[order], src[order]
        values = [values[int(i)] for i in order]
        M = len(group)
        counts = np.bincount(group, minlength=N)
        starts = np.zeros(N + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(M) - starts[group]
        K = int(counts.max(initial=1))
        vvs = np.zeros((N, K, Ru), np.int32)
        dids = np.full((N, K), NO_DOT, np.int32)
        dns = np.zeros((N, K), np.int32)
        valid = np.zeros((N, K), bool)
        vvs[group, pos] = vv
        dids[group, pos] = did
        dns[group, pos] = dn
        valid[group, pos] = True
        ceil = None
        if sweep_fn is not None:              # fused survival + ceilings
            mask, ceil = sweep_fn(vvs, dids, dns, valid)
            mask, ceil = np.asarray(mask), np.asarray(ceil)
        elif mask_fn is None:
            mask = B.sync_mask_np(vvs, dids, dns, valid)
        else:
            mask = np.asarray(mask_fn(vvs, dids, dns, valid))
        surv = mask[group, pos]
        # One survivor gather for the whole group; per-key outputs are
        # contiguous slices of it (rows are group-sorted already).
        s_all = np.flatnonzero(surv)
        vv_s, did_s, dn_s = vv[s_all], did[s_all], dn[s_all]
        if ceil is None:
            ceil = B.grouped_ceiling_np(vv_s, did_s, dn_s, group[s_all], N)
        sb = np.zeros(N + 1, np.int64)
        np.cumsum(np.bincount(group[s_all], minlength=N), out=sb[1:])
        # plain-int views: the string/set building below is pure Python
        s_list = s_all.tolist()
        vv_l, did_l, dn_l = vv_s.tolist(), did_s.tolist(), dn_s.tolist()
        wall_l = wall[s_all].tolist()
        ceil_l = ceil.tolist()
        sorted_cols = sorted((rid, c) for c, rid in enumerate(ids))
        n_stores = len(stores)
        ids_t = tuple(ids)
        for g, key in enumerate(gkeys):
            lo, hi = int(sb[g]), int(sb[g + 1])
            stale: Tuple[int, ...] = ()
            if track_stale:
                surv_set = set()
                member: List[set] = [set() for _ in range(n_stores)]
                for i in range(int(starts[g]), int(starts[g + 1])):
                    # row identity = clock AND value content: the
                    # clock-equal/value-different state (§6.1 gap) must
                    # flag as stale, never read as converged
                    rk = (vv[i].tobytes(), int(did[i]), int(dn[i]),
                          repr(values[i]))
                    member[int(src[i])].add(rk)
                    if surv[i]:
                        surv_set.add(rk)
                stale = tuple(j for j in range(n_stores)
                              if member[j] != surv_set)
            cg = ceil_l[g]
            out[key] = MergedRead(
                replica_ids=ids_t,
                vv=vv_s[lo:hi],
                dot_id=did_s[lo:hi],
                dot_n=dn_s[lo:hi],
                values=[values[i] for i in s_list[lo:hi]],
                walls=wall_l[lo:hi],
                clock_keys=[_clock_key(vv_l[i], did_l[i], dn_l[i],
                                       sorted_cols) for i in range(lo, hi)],
                entries=tuple(sorted(
                    (ids_t[c], cg[c]) for c in range(Ru) if cg[c] > 0)),
                stale=stale)
    return out


def quorum_merge_key(stores: Sequence[PackedVersionStore], key: str
                     ) -> Tuple[List[Any], List[float], List[str],
                                Tuple[Tuple[str, int], ...]]:
    """Merge one key's version sets across a read quorum of packed stores:
    the single-key view of ``quorum_merge_many`` (one group, one key).
    Returns ``(values, walls, clock_keys, ceiling_entries)`` for the
    survivors — no ``DVV`` object is created anywhere (the acceptance
    criterion for packed GET)."""
    m = quorum_merge_many({key: tuple(stores)}, (key,))[key]
    return m.values, m.walls, m.clock_keys, m.entries
