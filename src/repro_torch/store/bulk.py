"""Bulk anti-entropy: the batched CUDA DVV path for large key ranges.

With ``PackedVersionStore`` as the resident representation the steady-state
round is arrays end to end: the sender slices its slot arrays into a
``PackedPayload`` (zero decode), the receiver remaps replica columns with
one gather, groups rows per key with one stable sort, evaluates survival in
one ``sync_mask`` call — the numpy twin or the fused CUDA kernel
(``kernels.dvv_ops.dvv_sync_mask``, pairwise K×K dominance + survival in a
single launch on ``device``) — and writes the surviving rows back.  No per-key
``DVV`` object is encoded or decoded anywhere on that path.

Steady state runs *delta* rounds (DESIGN.md §6): phase 1 exchanges digest
trees (``PackedVersionStore.sync_digest``), phase 2 ships only the
divergent key ranges via ``payload(key_ranges=...)``.  ``delta_antientropy``
below is that two-phase round between two nodes; the one-shot full round
stays available as the fallback (non-packed peers, digest-collision
recovery) and as the conformance reference the delta round is tested
byte-identical to.

The object-level entry points (``bulk_sync`` on dicts of ``Version``s) are
kept for control-plane callers and for conformance testing against
``ReplicaNode``'s object backend; they pay the boundary codec once on the
way in and once on the way out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, \
    Tuple, Union

import numpy as np

from ..kernels.dvv_ops import dvv_sync_mask_bucketed
from .packed import PackedPayload, PackedVersionStore, StoreDigest
from .replica import PackedBackend, ReplicaNode, _as_object_payload
from .sharding import shard_of_key
from .version import Version

#: A per-push range budget: one cap for every shard, or a per-shard map
#: (the gossip driver's independently-adapted hot-shard budgets).
RangeBudget = Union[None, int, Mapping[int, Optional[int]]]


def _mask_fn(use_kernel: bool, device):
    if not use_kernel:
        return None                      # numpy twin inside packed
    # Shape-bucketed front end on the cluster's device: the CUDA kernel for
    # "cuda", its plain torch version for "cpu".
    return dvv_sync_mask_bucketed(device)


# ---------------------------------------------------------------------------
# Delta anti-entropy: digest exchange → ranked range request → sliced apply.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeltaSyncStats:
    """What one delta round cost and did — the wire/compute accounting the
    divergence benchmark reports per row."""

    buckets_total: int        # digest-tree width
    buckets_divergent: int    # leaves whose digests differed
    buckets_sent: int         # after ranking / max_ranges truncation
    payload_slots: int        # versions shipped in phase 2
    payload_bytes: int        # phase-2 wire size
    digest_bytes: int         # phase-1 wire size (both directions)
    changed: int              # keys whose version set changed at the receiver
    fallback: bool = False    # True when the full-payload round ran instead
    shard: int = -1           # which shard this round covered (-1: unsharded
                              # or an aggregate over shards)
    # Sharded rounds: the per-shard constituent stats (aggregates sum the
    # numeric fields above).  Empty for unsharded/per-shard entries.
    per_shard: Tuple["DeltaSyncStats", ...] = field(default=())


def rank_ranges(src_store: PackedVersionStore, divergent: np.ndarray,
                width: int, *,
                max_ranges: Optional[int] = None) -> np.ndarray:
    """Rank divergent buckets (ids at ``width``) for shipping, biggest first.

    The ranking key is the sender's live-slot count per bucket (the best
    local proxy for how much catch-up a range carries); ties break on
    bucket id so rounds are deterministic.  ``max_ranges`` caps a round.
    A push can only fix ranges where the *sender* is ahead, so a capped
    one-directional push can re-ship a receiver-ahead range forever;
    capped rounds converge when run in both directions (as
    ``KVCluster.delta_antientropy_round`` does) — the reverse push drains
    a receiver-ahead range, after which it drops out of both diffs.
    """
    if len(divergent) == 0:
        return divergent
    counts = src_store.bucket_counts(width)
    order = np.argsort(-counts[divergent], kind="stable")
    ranked = divergent[order]
    if max_ranges is not None:
        ranked = ranked[:max_ranges]
    return ranked


def delta_plan(src_store: PackedVersionStore, dst_digest: StoreDigest, *,
               max_ranges: Optional[int] = None
               ) -> Tuple[np.ndarray, int, int]:
    """Phase-1 planning: diff the digest trees (at the common width), rank
    the divergent ranges.  Returns ``(ranked_buckets, width, n_divergent)``
    where ``n_divergent`` counts divergent buckets before any
    ``max_ranges`` truncation."""
    width = min(src_store.n_buckets, dst_digest.n_buckets)
    divergent = src_store.sync_digest().diff(dst_digest)
    ranked = rank_ranges(src_store, divergent, width, max_ranges=max_ranges)
    return ranked, width, len(divergent)


def _object_payload_nbytes(payload: Dict[str, FrozenSet[Version]]) -> int:
    """Wire-size estimate for an object payload, comparable to
    ``PackedPayload.nbytes``: keys + clock reprs + value reprs."""
    return sum(
        len(k.encode())
        + sum(len(repr(v.clock).encode()) + len(repr(v.value).encode())
              for v in vs)
        for k, vs in payload.items())


def _store_delta_round(src_store: PackedVersionStore,
                       dst_store: PackedVersionStore, *,
                       mask_fn=None, max_ranges: Optional[int] = None,
                       shard: int = -1) -> DeltaSyncStats:
    """The two-phase round between two packed stores (one shard's plane)."""
    dst_digest = dst_store.sync_digest()
    ranked, width, n_divergent = delta_plan(src_store, dst_digest,
                                            max_ranges=max_ranges)
    # Phase-1 wire: each side's tree travels folded to the common width,
    # plus one 8-byte value root per side (the content check below).
    digest_bytes = 2 * (dst_digest.fold(width).nbytes() + 8)
    if len(ranked) == 0:
        if src_store.value_root() != dst_store.value_root():
            # The §6.1 hashes cover clock+key only, so clock-equal/value-
            # different slots (only reachable through non-protocol
            # ``bulk_sync`` dicts) diff to zero divergent buckets.  The
            # value roots disagree exactly then: run the full-payload
            # round rather than silently reporting convergence.
            payload = src_store.payload()
            changed = dst_store.apply_payload(payload, mask_fn=mask_fn)
            return DeltaSyncStats(width, 0, 0, len(payload),
                                  payload.nbytes(), digest_bytes, changed,
                                  fallback=True, shard=shard)
        return DeltaSyncStats(width, 0, 0, 0, 0, digest_bytes, 0,
                              shard=shard)
    payload = src_store.payload(key_ranges=ranked, ranges_width=width)
    changed = dst_store.apply_payload(payload, mask_fn=mask_fn)
    return DeltaSyncStats(width, n_divergent, len(ranked),
                          len(payload), payload.nbytes(), digest_bytes,
                          changed, shard=shard)


def _shard_budget(max_ranges: RangeBudget, shard: int) -> Optional[int]:
    if isinstance(max_ranges, Mapping):
        return max_ranges.get(shard)
    return max_ranges


def _aggregate_stats(per: List[DeltaSyncStats],
                     probe_bytes: int = 0) -> DeltaSyncStats:
    """Sum per-shard rounds into one stats record.  ``per_shard`` keeps
    only the shards that actually ran a round (the budget-adaptation
    signal); converged shards contribute ``probe_bytes`` of root-probe
    wire and nothing else — no stats object each, so a converged sharded
    heartbeat stays O(shards) int compares."""
    return DeltaSyncStats(
        buckets_total=sum(p.buckets_total for p in per),
        buckets_divergent=sum(p.buckets_divergent for p in per),
        buckets_sent=sum(p.buckets_sent for p in per),
        payload_slots=sum(p.payload_slots for p in per),
        payload_bytes=sum(p.payload_bytes for p in per),
        digest_bytes=sum(p.digest_bytes for p in per) + probe_bytes,
        changed=sum(p.changed for p in per),
        fallback=any(p.fallback for p in per),
        per_shard=tuple(per))


def _node_keys(node: ReplicaNode) -> List[str]:
    b = node.backend
    if isinstance(b, PackedBackend):
        return [k for st in b.stores for k in st.keys]
    return list(b.store.keys())


def delta_antientropy(src: ReplicaNode, dst: ReplicaNode, *,
                      use_kernel: bool = True, device="cuda",
                      max_ranges: RangeBudget = None,
                      only_shards: Optional[Iterable[int]] = None
                      ) -> DeltaSyncStats:
    """One two-phase delta round: ``src`` pushes its divergent ranges to
    ``dst``.  Cost is proportional to divergence, not store size.

    Sharded nodes run one round *per shard* — each shard's round opens
    with a 16-byte root probe (8B digest root + 8B value root per
    direction) so converged shards cost 32 wire bytes total instead of a
    tree snapshot, and ``max_ranges`` may be a per-shard mapping so hot
    shards get independent budgets.  ``only_shards`` restricts the round
    to the given shards — the rebalance plane: bootstrap pulls only the
    shards a joiner owns, handoff pushes only shards whose ownership
    changed.  The returned stats aggregate the per-shard rounds
    (``per_shard`` holds the constituents).

    Survival runs through the bucketed ``dvv_sync_mask`` on ``device`` (the
    CUDA kernel on "cuda", its plain torch version on "cpu");
    ``use_kernel=False`` asks for the numpy twin instead.

    Falls back to the one-shot full-payload round when either side lacks a
    packed store (object backends have no digest tree); ``only_shards``
    then filters the payload's keys by shard so both backends move the
    same key set.
    """
    sb, db = src.backend, dst.backend
    if not (isinstance(sb, PackedBackend) and isinstance(db, PackedBackend)):
        keys = None
        if only_shards is not None:
            want = frozenset(only_shards)
            keys = [k for k in _node_keys(src)
                    if shard_of_key(k, src.shards) in want]
        payload = src.antientropy_payload(keys)
        if isinstance(payload, PackedPayload):
            slots, nbytes = len(payload), payload.nbytes()
        else:
            slots = sum(len(vs) for vs in payload.values())
            nbytes = _object_payload_nbytes(payload)
        changed = bulk_receive_antientropy(dst, payload,
                                           use_kernel=use_kernel,
                                           device=device)
        return DeltaSyncStats(0, 0, 0, slots, nbytes, 0, changed,
                              fallback=True)

    if sb.shards != db.shards:
        raise ValueError(
            f"shard counts differ: {sb.shards} (src) vs {db.shards} (dst)")
    mask_fn = _mask_fn(use_kernel, device)
    if sb.shards == 1:
        # Unsharded: the exact pre-sharding protocol (no root probe — the
        # tree diff's own root compare is the converged fast path).
        return _store_delta_round(sb.stores[0], db.stores[0],
                                  mask_fn=mask_fn,
                                  max_ranges=_shard_budget(max_ranges, 0))
    targets = range(sb.shards) if only_shards is None \
        else sorted(frozenset(only_shards))
    per: List[DeltaSyncStats] = []
    probe_bytes = 0
    src_stores, dst_stores = sb.stores, db.stores
    for s in targets:
        ss, ds = src_stores[s], dst_stores[s]
        if ss.digest_root() == ds.digest_root() \
                and ss.value_root() == ds.value_root():
            # phase-0 skip: 8B digest root + 8B value root each direction
            probe_bytes += 32
            continue
        per.append(_store_delta_round(
            ss, ds, mask_fn=mask_fn,
            max_ranges=_shard_budget(max_ranges, s), shard=s))
    return _aggregate_stats(per, probe_bytes)


def bulk_receive_antientropy(node: ReplicaNode,
                             payload: Union[PackedPayload,
                                            Dict[str, FrozenSet[Version]]],
                             use_kernel: bool = True, device="cuda") -> int:
    """Apply a bulk anti-entropy payload to ``node``; returns #keys changed.

    Packed node + packed payload: single-launch array path (optionally the
    fused CUDA kernel on ``device``).  Object payloads are encoded at the
    boundary.  Object-backend DVV nodes still take the batched sweep (the whole point
    of this entry point); only non-DVV mechanisms fall back to the per-key
    object walk, as their clocks have no array encoding.
    """
    backend = node.backend
    if isinstance(backend, PackedBackend):
        if isinstance(payload, PackedPayload):
            return backend.receive_antientropy(
                payload, mask_fn=_mask_fn(use_kernel, device))
        # object payload at the boundary: encode once into a staging store,
        # then take the array path
        staged = _stage_object_payload(payload)
        return backend.receive_antientropy(
            staged.payload(), mask_fn=_mask_fn(use_kernel, device))
    if node.mechanism.name == "dvv":
        payload_obj = _as_object_payload(payload)
        # Sparse deltas: only stage keys the node actually stores — a key
        # with no local slots has nothing to merge against, and staging its
        # empty set would pay one boundary encode per absent key.
        local = {}
        for k in payload_obj:
            versions = node.versions(k)
            if versions:
                local[k] = versions
        new_sets = bulk_sync(local, payload_obj, use_kernel=use_kernel,
                             device=device)
        changed = 0
        for k, versions in new_sets.items():
            if versions != node.versions(k):
                changed += 1
            backend.replace_key(k, versions)
        return changed
    return backend.receive_antientropy(payload)


def _stage_object_payload(payload: Dict[str, FrozenSet[Version]]
                          ) -> PackedVersionStore:
    """Boundary codec: object versions → a throwaway packed store.

    Staging goes through ``sync_key`` so each key's set is reduced to its
    maximal antichain — arbitrary input dicts may contain internally
    dominated versions (protocol stores never do).
    """
    staged = PackedVersionStore(track_digests=False)   # scratch store: no
    for k in sorted(payload):                          # delta rounds, skip
        staged.sync_key_objects(k, payload[k])         # digest upkeep
    return staged


def bulk_sync(local: Dict[str, FrozenSet[Version]],
              incoming: Dict[str, FrozenSet[Version]],
              use_kernel: bool = True, device="cuda"
              ) -> Dict[str, FrozenSet[Version]]:
    """Object-level sync() per key, evaluated as one batched sweep.

    Returns the new version sets for every key in ``incoming`` ∪ ``local``.
    Both sides pay the boundary codec (this entry point exists for
    control-plane callers and conformance tests); resident stores use
    ``bulk_receive_antientropy`` with packed payloads instead.
    """
    if not local and not incoming:
        return {}
    staged = _stage_object_payload(local)
    staged.apply_payload(_stage_object_payload(incoming).payload(),
                         mask_fn=_mask_fn(use_kernel, device))
    return {k: staged.versions(k) for k in staged.keys}
