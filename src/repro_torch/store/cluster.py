"""The replicated key-value store (paper §4.1): proxy → coordinator → quorum.

GET:  proxy fans out to a read quorum of the key's replica nodes, merges the
      replies (on the packed backend: one array sweep, zero object-clock
      decodes) and returns (values, opaque ``CausalContext`` token).
PUT:  forwarded to a coordinator that is a replica node for the key; the
      coordinator mints the clock with ``update`` from the token's §5.4
      ceiling, syncs locally, then replicates the resulting version set
      asynchronously (via SimNetwork) to the remaining replicas; a write
      quorum is awaited synchronously.  ``put_many`` batches same-
      coordinator writes through one vectorized store update and one
      replication payload per destination.

Failures, partitions and delayed replication all flow through ``SimNetwork``
so tests and the training runtime can inject them deterministically.

The batched planes (``put_many``, ``get_many``, the delta rounds) sweep
survival through the bucketed ``kernels.dvv_ops`` front ends on the
cluster's ``device``: the CUDA kernels on "cuda" (the default, which
raises at construction when there is no card), their plain torch versions
on "cpu".  ``use_kernel=False`` asks for the numpy twin instead.  The
single-key ``put``/``get`` stay on the numpy twins: a device dispatch per
key would dominate them.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, List, Mapping, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from ..core.kernel import Mechanism
from ..kernels.dvv_ops import dvv_read_sweep_bucketed, \
    dvv_sync_mask_bucketed
from .bulk import DeltaSyncStats, RangeBudget, \
    delta_antientropy as _delta_antientropy
from .context import CausalContext
from .network import SimNetwork, Unavailable
from .packed import MergedRead, NO_DOT, PackedPayload, quorum_merge_key, \
    quorum_merge_many, remap_rows
from .replica import ReplicaNode
from .sharding import DEFAULT_PLACEMENT_SLICES, DEFAULT_VNODES, HashRing, \
    key_hash64, moved_shards, owned_shards, shard_of_key
from .version import HybridClock, Version, clocks_of, sync_versions
from .wal import DurableLog, LocalFS, ReplayStats

#: Default per-push range budget when gossip fanout sampling is active
#: (`delta_antientropy_round(fanout=...)`); caps a single round's payload
#: so steady-state gossip cost is bounded per tick.
DELTA_RANGE_BUDGET = 64


@dataclass(frozen=True)
class GetResult:
    values: Tuple[Any, ...]
    context: CausalContext            # opaque causal token (paper §5.4)
    siblings: int                     # number of concurrent versions returned
    # Per-value resolution keys (wall_time, clock, value), aligned with
    # ``values`` — the documented total order behind ``value``.
    resolution: Tuple[Tuple[float, str, str], ...] = ()

    @property
    def value(self) -> Any:
        """Deterministic resolved register: the sibling that is maximal in
        the (wall_time, clock, value) total order — latest coordinator
        wall-time wins; clock repr, then value repr, break exact ties.
        Purely a client-side convenience: no causal information is lost
        (all siblings stay in ``values``/``context``)."""
        if not self.values:
            return None
        if len(self.resolution) == len(self.values):
            best = max(range(len(self.values)),
                       key=self.resolution.__getitem__)
            return self.values[best]
        return self.values[-1]


@dataclass(frozen=True)
class PutAck:
    clock: Any
    coordinator: str
    replicated_to: Tuple[str, ...]


def _merged_result(values: Sequence[Any], walls: Sequence[float],
                   ckeys: Sequence[str],
                   entries: Tuple[Tuple[str, int], ...],
                   hlc: float = 0.0) -> GetResult:
    """``GetResult`` from merged packed survivor rows.  Each value's repr
    is computed once and shared by the sort key and the resolution tuple
    (it used to be computed twice per sibling on the hot read path).
    ``hlc`` is the geo tier's read watermark carried on the token (0.0 —
    the non-geo case — keeps the token byte-identical)."""
    reprs = [repr(v) for v in values]
    order = sorted(range(len(values)),
                   key=lambda i: (reprs[i], walls[i], ckeys[i]))
    return GetResult(
        values=tuple(values[i] for i in order),
        context=CausalContext(entries=entries, hlc=hlc),
        siblings=len(values),
        resolution=tuple((walls[i], ckeys[i], reprs[i]) for i in order))


def _object_result(acc: FrozenSet[Version], hlc: float = 0.0) -> GetResult:
    """``GetResult`` from an object-backend merged version set (same
    repr-once discipline and ``hlc`` watermark as the packed twin)."""
    keyed = [(v, repr(v.clock), repr(v.value)) for v in acc]
    keyed.sort(key=lambda t: (t[2], t[0].wall, t[1]))
    ctx = CausalContext.from_clocks(clocks_of(acc))
    if hlc:
        ctx = CausalContext(entries=ctx.entries, residue=ctx.residue,
                            hlc=hlc)
    return GetResult(
        values=tuple(t[0].value for t in keyed),
        context=ctx,
        siblings=len(acc),
        resolution=tuple((t[0].wall, t[1], t[2]) for t in keyed))


def _repair_payload(items: Sequence[Tuple[str, MergedRead]]) -> PackedPayload:
    """One consolidated read-repair push for one destination: the merged
    surviving rows of every key the member is stale on, re-encoded as a
    single ``PackedPayload`` — the same wire shape ``antientropy_payload``
    slices produce, so receivers apply it through the ordinary
    ``("store", payload)`` path and ``SimNetwork.bytes_sent`` prices it
    like any other anti-entropy transfer."""
    ids: List[str] = []
    index: Dict[str, int] = {}
    for _, m in items:
        for rid in m.replica_ids:
            if rid not in index:
                index[rid] = len(ids)
                ids.append(rid)
    Ru = len(ids)
    M = sum(len(m.values) for _, m in items)
    vv = np.zeros((M, Ru), np.int32)
    did = np.full(M, NO_DOT, np.int32)
    dn = np.zeros(M, np.int32)
    wall = np.zeros(M, np.float64)
    kix = np.zeros(M, np.int32)
    values: List[Any] = []
    off = 0
    for out_ix, (_, m) in enumerate(items):
        n = len(m.values)
        cols = np.asarray([index[r] for r in m.replica_ids], np.int64)
        vv[off: off + n], did[off: off + n] = \
            remap_rows(m.vv, m.dot_id, cols, Ru)
        dn[off: off + n] = m.dot_n
        wall[off: off + n] = m.walls
        kix[off: off + n] = out_ix
        values.extend(m.values)
        off += n
    return PackedPayload(
        replica_ids=tuple(ids), keys=tuple(k for k, _ in items),
        vv=vv, dot_id=did, dot_n=dn, key_ix=kix,
        values=tuple(values), wall=wall)


class KVCluster:
    """A set of replica nodes + the client-facing get/put protocol."""

    def __init__(self, node_ids: Sequence[str], mechanism: Mechanism, *,
                 replication: Optional[int] = None,
                 read_quorum: int = 1, write_quorum: int = 1,
                 network: Optional[SimNetwork] = None, seed: int = 0,
                 packed: Optional[bool] = None,
                 delta_range_budget: int = DELTA_RANGE_BUDGET,
                 shards: int = 1, vnodes: int = DEFAULT_VNODES,
                 datacenters: Optional[Mapping[str, Sequence[str]]] = None,
                 wan_period: float = 25.0,
                 wal_dir: Optional[str] = None,
                 wal_snapshot_every: int = 64,
                 wal_seal_bytes: int = 1 << 15,
                 wal_fs: Optional[Mapping[str, LocalFS]] = None,
                 device="cuda"):
        if not node_ids:
            raise ValueError("need at least one node")
        if shards < 1 or shards & (shards - 1):
            raise ValueError(
                f"shards must be a power of two >= 1, got {shards}")
        # The device the batched planes sweep survival on (``use_kernel``):
        # the CUDA kernels on "cuda", their plain torch versions on "cpu".
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "KVCluster(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the batched planes on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.mechanism = mechanism
        # packed=None: array-resident clocks for DVV, objects otherwise
        # (ReplicaNode decides); packed=False forces the object backend —
        # the conformance reference for the packed store.  Remembered so
        # nodes added later (``add_node``) get the same backend.
        self._packed = packed
        self.shards = shards
        # Placement granularity: with sharded stores, placement shard ==
        # store shard (rebalance is then exact at shard granularity); with
        # shards=1 keys still place through the ring at a fixed number of
        # hash-range slices, keeping the table O(1)-bounded either way.
        self._slices = shards if shards > 1 else DEFAULT_PLACEMENT_SLICES
        # hot-path constant: slice of a key = top bits of its 64-bit hash
        self._slice_shift = 64 - (self._slices.bit_length() - 1)
        self.nodes: Dict[str, ReplicaNode] = {
            n: ReplicaNode(n, mechanism, packed=packed, shards=shards)
            for n in node_ids}
        self.read_quorum = read_quorum
        self.write_quorum = write_quorum
        self.network = network or SimNetwork(seed=seed)
        self.clock_time = 0.0
        self.delta_range_budget = delta_range_budget
        self.seed = seed
        # Per-node hybrid logical clocks mint every ``Version.wall`` (the
        # geo tier's skew robustness; in a non-anomalous run the minted
        # values equal the raw shared clock, so single-DC behaviour is
        # unchanged down to the byte).
        self.hlc: Dict[str, HybridClock] = {n: HybridClock()
                                            for n in node_ids}
        # Geo tier (DESIGN.md §12): ``datacenters`` maps DC name → its
        # equal-sized node list.  The ring is then built over the FIRST
        # DC's nodes and placement rows are mirror-expanded, writes scope
        # their quorums to the coordinator's DC and ship cross-DC
        # asynchronously, and the snapshot read plane comes alive.
        self.geo = None
        if datacenters is not None:
            from .geo import GeoPlane
            self.geo = GeoPlane(self, datacenters, wan_period=wan_period)
        # replication counts nodes per DC in geo mode (mirror rows multiply
        # it by the DC count), defaulting to a full local DC.
        self.replication = replication or (
            len(node_ids) if self.geo is None else self.geo.dc_size)
        ring_ids = node_ids if self.geo is None \
            else self.geo.canonical_nodes
        self._ring = HashRing(ring_ids, vnodes=vnodes)
        self._rebuild_placement()
        # Seeded round-robin gossip schedule (delta_antientropy_round /
        # gossip_tick): each node's start offset is a pure function of
        # (seed, node id) — membership changes never reshuffle the schedule
        # of surviving nodes, so churn cannot break seed determinism.
        self._gossip_step = 0
        self._node_gossip_step: Dict[str, int] = {}
        self._gossip_base_cache: Dict[str, int] = {}
        # Plane-invocation meters: each fixed-cost entry into a read or
        # write plane (grouping, union-universe gather, bucket lookup,
        # per-destination payload assembly) counts once, however many keys
        # ride it.  The coalescing scheduler's whole thesis is driving
        # this number per-op toward zero; the serving benchmark reads it.
        self.plane_reads = 0
        self.plane_writes = 0
        # Self-driving membership (DESIGN.md §13): a MembershipController
        # registers itself here at construction.  When present, its
        # suspicion levels deprioritize suspect replicas in quorum
        # assembly/coordinator choice and steer the gossip driver; when
        # None (the default) every path below is byte-identical to the
        # hand-managed cluster.
        self.membership = None
        # Durability tier (DESIGN.md §14): with ``wal_dir`` set, every node
        # appends post-state records to per-shard segment logs under
        # ``wal_dir/<node>/shard-NN/`` and can come back warm via
        # ``restart_node``.  ``wal_dir=None`` (the default) leaves every
        # hook unset — byte-identical to the in-memory cluster.
        # ``incarnation`` counts process lifetimes per node id (bumped on
        # join and on every restart) so listeners like the gossip driver
        # can tell a restarted process from a surviving one.
        self.wal_dir = wal_dir
        self.wal: Dict[str, DurableLog] = {}
        self._wal_cfg = dict(snapshot_every=wal_snapshot_every,
                             seal_bytes=wal_seal_bytes)
        self._wal_fs = wal_fs or {}
        #: ReplayStats of the most recent ``restart_node`` (bench surface).
        self.last_replay: Optional[ReplayStats] = None
        self._epoch = 0
        self.incarnation: Dict[str, int] = {n: 1 for n in node_ids}
        if wal_dir is not None:
            if self.geo is not None:
                raise ValueError("durable logs are not supported on a geo "
                                 "cluster (membership there is static)")
            for n in node_ids:
                self._wal_attach(n)
            self._bump_epoch()

    # -- durability (DESIGN.md §14) -------------------------------------------
    def _wal_attach(self, node_id: str, *, reset: bool = False) -> None:
        log = self.wal.get(node_id)
        if log is None:
            log = self.wal[node_id] = DurableLog(
                self.wal_dir, node_id, fs=self._wal_fs.get(node_id),
                **self._wal_cfg)
        if reset:
            log.reset()
        log.attach(self.nodes[node_id])

    def _bump_epoch(self) -> None:
        """Stamp a new membership epoch into every attached node's log."""
        self._epoch += 1
        members = tuple(sorted(self.nodes))
        for node_id, log in self.wal.items():
            if log.node is not None:
                log.log_epoch(self._epoch, members)

    def restart_node(self, node_id: str, *,
                     use_kernel: bool = True) -> List[DeltaSyncStats]:
        """Warm restart from the durable log (the §14 recovery protocol).

        The crashed process's replica object is discarded and a fresh one
        is rebuilt from disk: reopen the shard manifests, truncate any
        torn tail (checksum-gated), replay snapshot + tail into packed
        columns / object sets (digest trees rebuild incrementally as the
        replay applies), then run exactly ONE digest-diffed delta pass per
        reachable peer — a pull (what the cluster wrote while this node
        was down) and a push (what this node coordinated or received but
        never finished replicating; the log keeps such writes alive even
        when the crash preempted their replication sends).  Both
        directions are O(divergence), not the O(store) ``bootstrap_node``
        path.  A node evicted by the MembershipController rejoins the
        ring here without a fresh-join bootstrap (warm readmit).
        """
        if self.geo is not None:
            raise ValueError("restart_node requires a non-geo cluster")
        log = self.wal.get(node_id)
        if log is None:
            raise ValueError(
                f"node {node_id!r} has no durable log (wal_dir unset)")
        if node_id in self.nodes:
            # In-place process bounce: same ring tokens and placement, new
            # replica object (the old process's memory is gone).
            self.nodes[node_id] = ReplicaNode(
                node_id, self.mechanism, packed=self._packed,
                shards=self.shards)
            self.hlc[node_id] = HybridClock()
            self.incarnation[node_id] = \
                self.incarnation.get(node_id, 0) + 1
        else:
            # Post-eviction readmit: rejoin ring + placement, no bootstrap.
            self._admit_node(node_id)
        self.last_replay = log.restore_into(self.nodes[node_id])
        if node_id in self.network.down:
            self.network.recover_node(node_id)
        else:
            self.network._topology_changed()
        self._bump_epoch()
        only = self._sync_shards(node_id)
        stats: List[DeltaSyncStats] = []
        for peer in list(self.nodes):
            if peer == node_id or \
                    not self.network.reachable(peer, node_id):
                continue
            # Sync only shards BOTH sides own: a peer outside shard s's
            # replica set holds nothing to pull, and pushing to it would
            # ship this node's whole shard into a store that doesn't own
            # it — O(store) wire for zero durability.
            pair = only
            if only is not None:
                peer_owned = self._owned.get(peer)
                if peer_owned is not None:
                    pair = only & peer_owned
                if not pair:
                    continue
            stats.append(self.delta_antientropy(
                peer, node_id, use_kernel=use_kernel, only_shards=pair))
            stats.append(self.delta_antientropy(
                node_id, peer, use_kernel=use_kernel, only_shards=pair))
        return stats

    # -- membership (dynamic: nodes join and leave at runtime) ----------------
    def _admit_node(self, node_id: str) -> None:
        """Shared join mechanics: replica + clock + ring + placement +
        topology event (no bootstrap, no durable-log reset)."""
        self.nodes[node_id] = ReplicaNode(node_id, self.mechanism,
                                          packed=self._packed,
                                          shards=self.shards)
        self.hlc[node_id] = HybridClock()
        self.incarnation[node_id] = self.incarnation.get(node_id, 0) + 1
        self._ring.add(node_id)
        self._rebuild_placement()
        # a join is a topology change too: listeners (the gossip driver)
        # adopt the newcomer immediately instead of on their next fire
        self.network._topology_changed()

    def add_node(self, node_id: str, *, bootstrap: bool = True,
                 bootstrap_ranges: Optional[int] = None,
                 use_kernel: bool = True) -> List[DeltaSyncStats]:
        """Join ``node_id`` to the cluster.

        The newcomer's vnode tokens land on the ring and the placement
        table is rebuilt — only the ~1/N of shards whose ring walk now
        meets a new token change replica sets — and, unless
        ``bootstrap=False``, the new node catches up *warm* via ranked
        digest-diffed pulls from every reachable peer (``bootstrap_node``;
        on a sharded cluster the pulls cover only the shards the newcomer
        now owns), so it serves reads with full causal state instead of
        empty version sets.  ``replication`` is a cluster parameter and
        does not change on join.
        """
        if self.geo is not None:
            raise ValueError("membership changes are not supported on a "
                             "geo cluster (mirror placement is static)")
        if node_id in self.nodes:
            raise ValueError(f"node {node_id!r} already in cluster")
        self._admit_node(node_id)
        if self.wal_dir is not None:
            # A *fresh* join wipes any log a previous incarnation of this
            # id left behind (its pre-departure state must not resurrect);
            # warm rejoins go through ``restart_node`` instead.
            self._wal_attach(node_id, reset=True)
            self._bump_epoch()
        if bootstrap:
            return self.bootstrap_node(node_id, max_ranges=bootstrap_ranges,
                                       use_kernel=use_kernel)
        return []

    def remove_node(self, node_id: str, *, handoff: bool = True,
                    handoff_ranges: Optional[int] = None
                    ) -> List[DeltaSyncStats]:
        """Depart ``node_id``: drop its replica, rehash placement, purge
        messages addressed to it from the fabric.

        A *planned* departure first hands the node's state off — one final
        delta push to every reachable survivor — so writes for which it
        held the only copy (e.g. quorum-1 writes acked during a partition)
        survive the decommission.  On a sharded cluster the handoff is
        placement-aware: only shards whose replica set changed travel, and
        each survivor receives just the moved shards it now owns — bytes
        moved scale with the departing node's ~K/N share, not the store.
        ``handoff=False`` models a crash-style removal; an unreachable/
        down node naturally hands off nothing.  Surviving nodes' gossip
        schedules are untouched (offsets are per-node functions of the
        seed), so removal never reshuffles peer sampling determinism."""
        if self.geo is not None:
            raise ValueError("membership changes are not supported on a "
                             "geo cluster (mirror placement is static)")
        if node_id not in self.nodes:
            raise KeyError(f"node {node_id!r} not in cluster")
        if len(self.nodes) == 1:
            raise ValueError("cannot remove the last node")
        stats: List[DeltaSyncStats] = []
        before = self._placement
        self._ring.remove(node_id)
        self._rebuild_placement()
        if handoff:
            moved = frozenset(moved_shards(before, self._placement)) \
                if self.shards > 1 else None
            for peer in list(self.nodes):
                if peer == node_id or \
                        not self.network.reachable(node_id, peer):
                    continue
                only: Optional[frozenset] = None
                if moved is not None:
                    only = moved & self._owned.get(peer, frozenset())
                    if not only:
                        continue
                stats.append(self.delta_antientropy(
                    node_id, peer, max_ranges=handoff_ranges,
                    only_shards=only))
        del self.nodes[node_id]
        self._owned.pop(node_id, None)
        self._node_gossip_step.pop(node_id, None)
        self.network.forget(node_id)
        if (log := self.wal.get(node_id)) is not None:
            # Keep the DurableLog object (and its files): a later
            # ``restart_node`` readmits warm from it; a later fresh
            # ``add_node`` wipes it.
            log.detach()
        if self.wal_dir is not None:
            self._bump_epoch()
        return stats

    def bootstrap_node(self, node_id: str, *,
                       max_ranges: Optional[int] = None,
                       use_kernel: bool = True,
                       max_passes: int = 64) -> List[DeltaSyncStats]:
        """Warm catch-up for a (typically fresh) node: repeated ranked
        digest-diffed delta pulls from every reachable peer, biggest ranges
        first (``payload(key_ranges=...)`` does the slicing), until a full
        pass over the peers changes nothing at the newcomer.  Progress is
        measured by ``changed`` (the newcomer's sets growing toward the
        union), which is finite — so the loop terminates even when peers
        stay mutually divergent among themselves.  ``max_ranges`` bounds
        one pull so a joining node can rate-limit its catch-up; uncapped,
        two passes suffice (the second proves quiescence).  On a sharded
        cluster the pulls are restricted to the shards ``node_id`` owns
        under the current placement — the rebalance plane moves the
        joiner's ~K/N share, not every peer's whole store."""
        only = self._sync_shards(node_id)
        stats: List[DeltaSyncStats] = []
        for _ in range(max_passes):
            progress = False
            for peer in list(self.nodes):
                if peer == node_id or \
                        not self.network.reachable(peer, node_id):
                    continue
                st = self.delta_antientropy(peer, node_id,
                                            use_kernel=use_kernel,
                                            max_ranges=max_ranges,
                                            only_shards=only)
                stats.append(st)
                if st.changed:
                    progress = True
            if not progress:
                break
        return stats

    # -- placement (consistent-hash ring) -------------------------------------
    def _rebuild_placement(self) -> None:
        """Recompute the O(slices) placement table from the ring — the only
        placement state there is (bounded by the slice count, never by the
        key universe; per-key lookup is then one hash + one index).  Geo
        mode expands each canonical (first-DC) row to its mirror rows:
        slot i of every DC owns slot i of the first DC's key ranges, so
        every DC holds a full copy and WAN delta rounds between mirror
        pairs are digest-comparable."""
        table = self._ring.placement_table(self._slices, self.replication)
        if self.geo is not None:
            table = [tuple(m for n in row for m in self.geo.mirrors(n))
                     for row in table]
        self._placement = table
        self._owned: Dict[str, frozenset] = (
            {n: owned_shards(self._placement, n) for n in self.nodes}
            if self.shards > 1 else {})

    def _sync_shards(self, node_id: str) -> Optional[frozenset]:
        """The shard filter for rebalance transfers involving ``node_id``:
        the shards it owns, or ``None`` (no filtering) when stores are
        unsharded or replication spans every node (everyone owns every
        shard, so filtering would be a no-op)."""
        if self.shards <= 1 or self.replication >= len(self.nodes):
            return None
        return self._owned.get(node_id)

    def replicas_for(self, key: str) -> Sequence[str]:
        """The key's replica set: one stable 64-bit hash (blake2b-8), one
        table index — O(1) per key, over a table the membership-change
        path rebuilds in O(slices · log V).  Returns the table's own
        (immutable) tuple — the hot path allocates nothing."""
        return self._placement[key_hash64(key) >> self._slice_shift]

    def _reachable_replicas(self, via: str, key: str) -> List[str]:
        reachable = [r for r in self.replicas_for(key)
                     if self.network.reachable(via, r)]
        # Local read preference: if the proxy is itself a replica, contact it
        # first (how Riak/Dynamo coordinators behave).  With a membership
        # controller attached, suspect replicas sort last — a quorum that
        # can be filled from non-suspect members never waits on a node the
        # failure detector already distrusts (the sort is stable, so the
        # non-suspect order is unchanged).
        mem = self.membership
        if mem is None:
            reachable.sort(key=lambda r: (r != via,))
        else:
            now = self.network.now
            reachable.sort(
                key=lambda r: (r != via, mem.is_suspect(r, now)))
        return reachable

    def _pick_coordinator(self, proxy: str, key: str,
                          coordinator: Optional[str] = None) -> str:
        """A reachable replica node to coordinate a PUT (paper step 2)."""
        if coordinator is not None:
            if not self.network.reachable(proxy, coordinator):
                raise Unavailable(f"coordinator {coordinator} unreachable")
            return coordinator
        candidates = [r for r in self.replicas_for(key)
                      if self.network.reachable(proxy, r)]
        if not candidates:
            raise Unavailable(f"no reachable coordinator for {key!r}")
        # Prefer coordinating at the proxy itself when it is a replica
        # (local coordination preserves read-your-writes via one node);
        # geo mode then prefers the proxy's own DC — commit latency stays
        # LAN-local, the geo tier's write-path promise.
        if self.geo is not None:
            pdc = self.geo.dc_of.get(proxy)
            candidates.sort(
                key=lambda r: (r != proxy, self.geo.dc_of[r] != pdc))
        elif self.membership is not None:
            # never coordinate a write at a suspect if a trusted replica
            # is available: a coordinator about to be evicted is the
            # sole-copy-write risk the controller exists to retire
            now = self.network.now
            candidates.sort(
                key=lambda r: (r != proxy,
                               self.membership.is_suspect(r, now)))
        else:
            candidates.sort(key=lambda r: (r != proxy,))
        return candidates[0]

    # -- admission probes (non-raising; the op-scheduler's per-op triage) -----
    def probe_read(self, key: str, *, via: str, quorum: int) -> bool:
        """Would a GET for ``key`` via ``via`` assemble its read quorum
        right now?  Pure reachability arithmetic — no store touched, no
        exception raised — so a scheduler can fail one op without
        poisoning its whole flush."""
        if via in self.network.down:
            return False
        return len(self._reachable_replicas(via, key)) >= quorum

    def probe_write(self, key: str, *, via: str) -> Tuple[Optional[str], int]:
        """``(coordinator, predicted_acks)`` for a PUT of ``key`` via
        ``via`` — coordinator ``None`` when none is reachable.  Predicted
        acks = coordinator + destinations currently reachable from it;
        exact when ``drop_rate == 0`` (the conformance regime), an upper
        bound otherwise."""
        if via in self.network.down:
            return None, 0
        try:
            coord = self._pick_coordinator(via, key)
        except Unavailable:
            return None, 0
        acks = 1 + sum(1 for r in self.replicas_for(key)
                       if r != coord and self.network.reachable(coord, r))
        return coord, acks

    @property
    def plane_invocations(self) -> int:
        return self.plane_reads + self.plane_writes

    # -- wall minting (hybrid logical clocks) ---------------------------------
    def _mint_wall(self, coordinator: str, ctx: CausalContext,
                   wall_time: Optional[float]) -> float:
        """Mint a write's wall at the coordinator's hybrid clock.

        In a non-anomalous run ``mint(clock_time)`` returns exactly
        ``clock_time`` (the shared clock strictly increases, so the
        physical branch always wins) — pre-geo behaviour to the byte; a
        stalled or backwards-stepping clock falls into the logical
        tiebreak and walls stay strictly increasing per coordinator.  Geo
        mode first folds in the token's read watermark and the
        coordinator's own wall-column max, making causal order imply wall
        order (what snapshot consistency rests on).  An explicit
        ``wall_time`` bypasses minting (a test hook; geo snapshot
        guarantees assume coordinator-minted walls)."""
        h = self.hlc[coordinator]
        if wall_time is not None:
            if self.geo is not None:
                h.observe(wall_time)
            return wall_time
        if self.geo is not None:
            if ctx.hlc:
                h.observe(ctx.hlc)
            h.observe(self.nodes[coordinator].max_wall)
        return h.mint(self.clock_time)

    def _read_watermark(self, walls: Iterable[float]) -> float:
        """HLC watermark a read stamps on its context token (geo only —
        non-geo tokens stay byte-identical to pre-geo ones): the max wall
        among returned versions, so a dependent write minted anywhere
        lands strictly above everything this read saw."""
        if self.geo is None:
            return 0.0
        return max((float(w) for w in walls), default=0.0)

    # -- client operations -------------------------------------------------------
    def _object_read(self, key: str, chosen: Sequence[ReplicaNode]
                     ) -> FrozenSet[Version]:
        """Object-backend quorum merge for one key (the generic path)."""
        acc: FrozenSet[Version] = frozenset()
        for node in chosen:
            acc = sync_versions(
                acc, node.versions(key),
                total_order=not self.mechanism.tracks_concurrency)
        return acc

    def get(self, key: str, *, via: Optional[str] = None,
            quorum: Optional[int] = None) -> GetResult:
        proxy = via or next(iter(self.nodes))
        if proxy in self.network.down:
            raise Unavailable(f"proxy {proxy} is down")
        quorum = quorum or self.read_quorum
        reachable = self._reachable_replicas(proxy, key)
        if len(reachable) < quorum:
            raise Unavailable(
                f"read quorum {quorum} unreachable for {key!r} via {proxy}")
        chosen = [self.nodes[r] for r in reachable[:max(quorum, 1)]]
        self.plane_reads += 1
        if all(n.is_packed for n in chosen):
            # Array-native read path: quorum merge + §5.4 ceiling token
            # straight from the int32 columns (the key's shard store) —
            # zero object-clock decodes.
            values, walls, ckeys, entries = quorum_merge_key(
                [n.store_for(key) for n in chosen], key)
            return _merged_result(values, walls, ckeys, entries,
                                  hlc=self._read_watermark(walls))
        acc = self._object_read(key, chosen)
        return _object_result(
            acc, hlc=self._read_watermark(v.wall for v in acc))

    def get_many(self, keys: Sequence[str], *, via: Optional[str] = None,
                 quorum: Optional[int] = None, repair: bool = False,
                 use_kernel: bool = True) -> Dict[str, GetResult]:
        """Multi-key GET through one proxy — the batched read plane.

        Admission mirrors ``put_many``: proxy reachability and the read
        quorum are resolved for *every* key up front, and ``Unavailable``
        is raised before any store is touched — a failing key never
        discards already-merged results.  Keys whose whole quorum is
        packed then run as grouped quorum merges (``quorum_merge_many``):
        one union-universe remap per quorum set, one stacked ``[N, K, R]``
        survival sweep (``use_kernel=True``, the default, routes it through
        the fused §6.4 shape-bucketed read sweep on the cluster's device,
        survival + ceilings in one pass; ``use_kernel=False`` asks for the
        numpy twin), one grouped §5.4 ceiling reduce.  Mixed/object
        quorums fall back to the per-key merge.

        ``repair=True`` closes the Dynamo read-repair loop: any quorum
        member whose live rows for a key differ from the merged survivors
        receives ONE consolidated ``("store", payload)`` push covering all
        of its stale keys (sent from the proxy, priced by
        ``SimNetwork.bytes_sent`` like any anti-entropy transfer; a stale
        *proxy* applies its payload locally instead of mailing itself),
        so hot keys converge on the read path instead of waiting for
        gossip.  A converged quorum generates zero repair traffic.
        """
        proxy = via or next(iter(self.nodes))
        if proxy in self.network.down:
            raise Unavailable(f"proxy {proxy} is down")
        quorum = quorum or self.read_quorum
        # -- admission: resolve every key's quorum before touching stores.
        # ONE atomic pass across all shards; keys sharing a placement slice
        # share one reachability resolution (same replica set, same fabric
        # state within the call).
        chosen: Dict[str, List[str]] = {}
        short: List[str] = []
        slice_reach: Dict[int, List[str]] = {}
        for key in keys:
            sl = shard_of_key(key, self._slices)
            reachable = slice_reach.get(sl)
            if reachable is None:
                reachable = slice_reach[sl] = \
                    self._reachable_replicas(proxy, key)
            if len(reachable) < quorum:
                short.append(key)
            else:
                chosen[key] = reachable[: max(quorum, 1)]
        if short:
            raise Unavailable(
                f"read quorum {quorum} unreachable for {len(short)}/"
                f"{len(chosen) + len(short)} keys via {proxy} "
                f"(e.g. {short[:3]})")
        results: Dict[str, GetResult] = {}
        packed_repairs: Dict[str, List[Tuple[str, MergedRead]]] = {}
        object_repairs: Dict[str, Dict[str, FrozenSet[Version]]] = {}
        packed_keys = [k for k, ids in chosen.items()
                       if all(self.nodes[r].is_packed for r in ids)]
        # one plane entry for the whole packed batch; each mixed/object
        # key below falls back to its own per-key merge (counted there)
        if packed_keys:
            self.plane_reads += 1
            sweep_fn = None
            if use_kernel:
                sweep_fn = dvv_read_sweep_bucketed(self.device)
            # Stores are per-(node, shard): quorum_merge_many's grouping by
            # store-identity tuple therefore fans the sweep out per
            # (shard, quorum-group) — each group one stacked tensor.
            merged = quorum_merge_many(
                {k: [self.nodes[r].store_for(k) for r in chosen[k]]
                 for k in packed_keys},
                packed_keys, sweep_fn=sweep_fn, track_stale=repair)
            for k, m in merged.items():
                results[k] = _merged_result(m.values, m.walls, m.clock_keys,
                                            m.entries,
                                            hlc=self._read_watermark(m.walls))
                if repair:
                    for j in m.stale:
                        packed_repairs.setdefault(
                            chosen[k][j], []).append((k, m))
        for k, ids in chosen.items():
            if k in results:
                continue
            self.plane_reads += 1
            acc = self._object_read(k, [self.nodes[r] for r in ids])
            results[k] = _object_result(
                acc, hlc=self._read_watermark(v.wall for v in acc))
            if repair:
                for r in ids:
                    if self.nodes[r].versions(k) != acc:
                        object_repairs.setdefault(r, {})[k] = acc
        if repair:
            # A stale proxy repairs itself locally (it IS this process —
            # no self-addressed wire message, no phantom bytes_sent); every
            # other stale member gets its one consolidated push.
            for dst, items in packed_repairs.items():
                payload = _repair_payload(items)
                if dst == proxy:
                    self.nodes[dst].receive_antientropy(payload)
                else:
                    self.network.send(proxy, dst, ("store", payload))
            for dst, payload in object_repairs.items():
                if dst == proxy:
                    self.nodes[dst].receive_antientropy(payload)
                else:
                    self.network.send(proxy, dst, ("store", payload))
        return {k: results[k] for k in chosen}

    # -- causal snapshot reads (geo tier, DESIGN.md §12) --------------------
    def probe_snapshot(self, keys: Sequence[str],
                       *, via: Optional[str] = None) -> Optional[str]:
        """Admission probe for a snapshot batch: the failure reason a
        ``snapshot_get_many`` with these keys would raise, or ``None`` if
        it would be served.  The scheduler uses this to admit/defer
        snapshot ops without tripping exceptions."""
        if self.geo is None:
            return "snapshot reads require a geo cluster (datacenters=...)"
        proxy = via or next(iter(self.nodes))
        for key in keys:
            reason = self.geo.check_snapshot(proxy, key)
            if reason is not None:
                return reason
        return None

    def snapshot_get(self, key: str, *, via: Optional[str] = None
                     ) -> GetResult:
        """Causally consistent, possibly stale read served entirely from
        the proxy's datacenter — zero WAN round trips (single-key form of
        ``snapshot_get_many``)."""
        return self.snapshot_get_many([key], via=via)[key]

    def snapshot_get_many(self, keys: Sequence[str],
                          *, via: Optional[str] = None
                          ) -> Dict[str, GetResult]:
        """Batched causal snapshot read at the proxy's DC (DESIGN.md §12).

        The batch is served at ONE Global Stable Frontier F — the wall
        below which every version is provably held by at least one local
        member (the min-fold over member HLCs, queued replication
        messages, WAN-shipping backlogs and dropped-send backlogs).  Per
        key, the *union* of all local replicas' live versions and their
        retained stable shadows is filtered to wall ≤ F and sibling-merged
        — so two keys written causally (read k1 → put k2) can never appear
        inverted: the later write's wall is strictly larger, and any
        version ≤ F is guaranteed present locally.  No WAN message is sent
        or awaited; results may lag remote commits by the frontier lag.
        Admission is atomic (any key failing the local-coverage check
        raises before any merge), mirroring ``get_many``.
        """
        if self.geo is None:
            raise RuntimeError(
                "snapshot reads require a geo cluster (datacenters=...)")
        proxy = via or next(iter(self.nodes))
        failures = []
        for key in keys:
            reason = self.geo.check_snapshot(proxy, key)
            if reason is not None:
                failures.append((key, reason))
        if failures:
            raise Unavailable(
                f"snapshot unavailable for {len(failures)}/{len(keys)} "
                f"keys via {proxy} (e.g. {failures[:2]})")
        self.plane_reads += 1
        dc = self.geo.dc_of[proxy]
        frontier = self.geo.stable_frontier(dc)
        out: Dict[str, GetResult] = {}
        for key in keys:
            acc = self.geo.snapshot_versions(dc, key, frontier)
            out[key] = _object_result(
                acc, hlc=max((v.wall for v in acc), default=0.0))
        return out

    def put(self, key: str, value: Any, context: Any = None,
            *, via: Optional[str] = None, client_id: str = "?",
            client_counter: int = 0, wall_time: Optional[float] = None,
            coordinator: Optional[str] = None,
            quorum: Optional[int] = None) -> PutAck:
        proxy = via or next(iter(self.nodes))
        if proxy in self.network.down:
            raise Unavailable(f"proxy {proxy} is down")
        quorum = quorum or self.write_quorum
        self.clock_time += 1.0

        ctx = CausalContext.coerce(context)
        coordinator = self._pick_coordinator(proxy, key, coordinator)
        wall = self._mint_wall(coordinator, ctx, wall_time)
        self.plane_writes += 1
        node = self.nodes[coordinator]
        version = node.coordinate_update(
            key, value, ctx, client_id=client_id,
            client_counter=client_counter, wall_time=wall)

        # replicate S_C' to the other replicas (paper step 4): async
        # messages carrying the wire payload (packed: int32 arrays, no
        # object clocks on the control plane either).  Geo mode scopes this
        # synchronous fan-out (and the write quorum) to the coordinator's
        # own datacenter; mirrors in other DCs get the payload later via
        # the WAN shipper's digest-diffed delta rounds.
        geo = self.geo
        cdc = geo.dc_of[coordinator] if geo is not None else None
        payload = node.antientropy_payload([key])
        acked = [coordinator]
        for r in self.replicas_for(key):
            if r == coordinator:
                continue
            if geo is not None and geo.dc_of[r] != cdc:
                continue
            sent = self.network.send(coordinator, r, ("store", payload))
            if sent:
                acked.append(r)
            elif geo is not None:
                geo.note_send_failed(coordinator, r, wall)
        if geo is not None:
            geo.on_commit(cdc, (wall,))
        if len(acked) < quorum:
            # The write is still durable at the coordinator (always-writable
            # store) but the caller asked for more replicas than reachable.
            raise Unavailable(
                f"write quorum {quorum} > reachable replicas {len(acked)}")
        return PutAck(clock=version.clock, coordinator=coordinator,
                      replicated_to=tuple(acked))

    def put_many(self, items: Mapping[str, Tuple[Any, Any]], *,
                 via: Optional[str] = None, client_id: str = "?",
                 client_counter: int = 0, quorum: Optional[int] = None,
                 use_kernel: bool = True) -> Dict[str, PutAck]:
        """Batched multi-key PUT: ``{key: (value, context)}`` → per-key acks.

        Keys are grouped by coordinator; each same-coordinator group runs
        as ONE vectorized store update (one grouped encode → one
        ``sync_mask`` sweep → one scatter) and ONE replication payload per
        destination replica, instead of K independent ``sync_key`` walks
        and K·(R−1) messages.  Admission is atomic: if any key has no
        reachable coordinator, nothing is written.  Writes are always
        durable at their coordinators; if any key then misses its write
        quorum, ``Unavailable`` is raised after the batch is applied
        (mirroring the single-key contract).
        """
        proxy = via or next(iter(self.nodes))
        if proxy in self.network.down:
            raise Unavailable(f"proxy {proxy} is down")
        quorum = quorum or self.write_quorum

        groups: Dict[str, List[str]] = {}
        ctxs: Dict[str, CausalContext] = {}
        walls: Dict[str, float] = {}
        coord_of: Dict[str, str] = {}
        slice_coord: Dict[int, str] = {}
        for key, (value, context) in items.items():
            ctxs[key] = CausalContext.coerce(context)
            # one admission resolution per placement slice (atomic across
            # shards: any key without a reachable coordinator raises here,
            # before any store is touched)
            sl = shard_of_key(key, self._slices)
            coord = slice_coord.get(sl)
            if coord is None:
                coord = slice_coord[sl] = self._pick_coordinator(proxy, key)
            coord_of[key] = coord
            groups.setdefault(coord, []).append(key)
        minted: Dict[str, Version] = {}
        acked: Dict[str, List[str]] = {}
        mask_fn = None
        if use_kernel:
            mask_fn = dvv_sync_mask_bucketed(self.device)
        geo = self.geo
        for key in items:
            self.clock_time += 1.0
            walls[key] = self._mint_wall(coord_of[key], ctxs[key], None)
        for coord, keys in groups.items():
            self.plane_writes += 1
            cdc = geo.dc_of[coord] if geo is not None else None
            node = self.nodes[coord]
            batch = [(k, ctxs[k], items[k][0], walls[k]) for k in keys]
            versions = node.coordinate_updates(
                batch, client_id=client_id, client_counter=client_counter,
                mask_fn=mask_fn)
            for k, v in zip(keys, versions):
                minted[k] = v
                acked[k] = [coord]
            # One replication payload per destination: all of this
            # coordinator's keys that destination replicates.  Geo mode
            # fans out local-DC only (mirrors ride the WAN shipper).
            dst_keys: Dict[str, List[str]] = {}
            for k in keys:
                for r in self.replicas_for(k):
                    if r == coord:
                        continue
                    if geo is not None and geo.dc_of[r] != cdc:
                        continue
                    dst_keys.setdefault(r, []).append(k)
            # Destinations replicating the same key set share one payload
            # object (receivers never mutate payloads; single-key put
            # already relies on this).
            payload_cache: Dict[Tuple[str, ...], Any] = {}
            for dst, ks in dst_keys.items():
                sig = tuple(ks)
                payload = payload_cache.get(sig)
                if payload is None:
                    payload = payload_cache[sig] = \
                        node.antientropy_payload(ks)
                if self.network.send(coord, dst, ("store", payload)):
                    for k in ks:
                        acked[k].append(dst)
                elif geo is not None:
                    for k in ks:
                        geo.note_send_failed(coord, dst, walls[k])
            if geo is not None:
                geo.on_commit(cdc, tuple(walls[k] for k in keys))
        failed = [k for k in items if len(acked[k]) < quorum]
        if failed:
            raise Unavailable(
                f"write quorum {quorum} unreachable for "
                f"{len(failed)}/{len(items)} keys (e.g. {failed[:3]})")
        return {k: PutAck(clock=minted[k].clock, coordinator=coord_of[k],
                          replicated_to=tuple(acked[k]))
                for k in items}

    # -- background machinery ------------------------------------------------------
    def deliver_replication(self, max_messages: Optional[int] = None,
                            until: Optional[float] = None) -> int:
        """Flush queued coordinator→replica store messages (``until`` limits
        delivery to messages due by that simulated time — the gossip
        driver's per-tick drain)."""
        def handler(msg):
            kind, payload = msg.payload
            assert kind == "store"
            self.nodes[msg.dst].receive_antientropy(payload)
            if self.geo is not None:
                self.geo.note_receive(msg.dst, msg.payload)
        return self.network.deliver(handler, until=until,
                                    max_messages=max_messages)

    def antientropy(self, src: str, dst: str,
                    keys: Optional[Sequence[str]] = None) -> None:
        """Replica `src` pushes state to `dst` (paper §4.1 Anti-entropy)."""
        if not self.network.reachable(src, dst):
            raise Unavailable(f"{src} -> {dst} unreachable")
        payload = self.nodes[src].antientropy_payload(keys)
        self.nodes[dst].receive_antientropy(payload)
        if self.geo is not None:
            self.geo.note_delta_round(src, dst)

    def antientropy_round(self) -> None:
        """One full push round between all reachable pairs."""
        ids = list(self.nodes)
        for a in ids:
            for b in ids:
                if a != b and self.network.reachable(a, b):
                    self.antientropy(a, b)

    def delta_antientropy(self, src: str, dst: str, *,
                          use_kernel: bool = True,
                          max_ranges: RangeBudget = None,
                          only_shards: Optional[Iterable[int]] = None
                          ) -> DeltaSyncStats:
        """Two-phase delta round (paper §4.1 anti-entropy, DESIGN.md §6):
        digest exchange, then only the divergent key ranges travel.  On a
        sharded cluster the round runs per shard (root-probe fast path for
        converged shards; ``max_ranges`` may map shard → budget);
        ``only_shards`` restricts it — the rebalance plane."""
        if not self.network.reachable(src, dst):
            raise Unavailable(f"{src} -> {dst} unreachable")
        stats = _delta_antientropy(self.nodes[src], self.nodes[dst],
                                   use_kernel=use_kernel, device=self.device,
                                   max_ranges=max_ranges,
                                   only_shards=only_shards)
        if self.geo is not None:
            self.geo.note_delta_round(src, dst)
        return stats

    def _gossip_base(self, node: str) -> int:
        """A node's gossip start offset: a pure function of (seed, node id),
        stable under membership churn — joins and leaves never reshuffle
        the rotation of surviving nodes."""
        base = self._gossip_base_cache.get(node)
        if base is None:
            base = self._gossip_base_cache[node] = random.Random(
                f"{self.seed}:{node}").randrange(1 << 30)
        return base

    def gossip_peers(self, node: str, k: int, step: int) -> List[str]:
        """The ``k`` peers ``node`` pushes to at rotation ``step``, sampled
        from *current* membership — departed nodes drop out of the rotation
        naturally (they are simply absent), reachability is checked by the
        caller.  Repeated steps cycle every node through all live peers.
        In geo mode gossip stays LAN-scoped — a node rotates only through
        its own datacenter; cross-DC convergence is the WAN shipper's job
        (digest-diffed delta rounds per link, not N² WAN chatter)."""
        if self.geo is not None and node in self.geo.dc_of:
            ids = list(self.geo.dcs[self.geo.dc_of[node]])
        else:
            ids = list(self.nodes)
        n = len(ids)
        if node not in self.nodes or n < 2:
            return []
        i = ids.index(node)
        peers = ids[i + 1:] + ids[:i]              # all others, rotated
        k = max(1, min(k, n - 1))
        off = (self._gossip_base(node) + step * k) % (n - 1)
        return [peers[(off + j) % (n - 1)] for j in range(k)]

    def gossip_tick(self, node: str, *, step: Optional[int] = None,
                    fanout: int = 1, max_ranges: RangeBudget = None,
                    use_kernel: bool = True,
                    exclude: FrozenSet[str] = frozenset()
                    ) -> List[Tuple[str, DeltaSyncStats]]:
        """One node's bounded gossip pushes — the unit the continuous
        ``GossipDriver`` fires per timer (its adaptation needs to know
        which peer each round hit, hence ``(peer, stats)`` pairs).
        ``step`` defaults to a per-node counter so hand-cranked ticks
        still cycle all peers; ``max_ranges`` defaults to
        ``delta_range_budget``.  Unreachable sampled peers are skipped
        (the tick is best-effort), as are peers in ``exclude`` — the
        driver's suspicion backoff: suspects leave the regular rotation
        (skipping never perturbs the seeded schedule itself) and get a
        dedicated probe round instead."""
        if node not in self.nodes:
            return []
        if step is None:
            step = self._node_gossip_step.get(node, 0)
            self._node_gossip_step[node] = step + 1
        if max_ranges is None:
            max_ranges = self.delta_range_budget
        out = []
        for b in self.gossip_peers(node, fanout, step):
            if b not in exclude and self.network.reachable(node, b):
                out.append((b, self.delta_antientropy(
                    node, b, use_kernel=use_kernel, max_ranges=max_ranges)))
        return out

    def delta_antientropy_round(self, *, use_kernel: bool = True,
                                max_ranges: Optional[int] = None,
                                fanout: Optional[int] = None
                                ) -> List[DeltaSyncStats]:
        """One seeded round-robin delta push round (gossip scheduling).

        Every node pushes to ``fanout`` peers chosen by a deterministic
        rotating schedule (seeded start offset + round counter), so
        repeated rounds cycle each node through *all* peers — probabilistic
        peer sampling without losing the coverage guarantee.  With
        ``fanout=None`` (default) each node pushes to every reachable peer,
        the all-pairs behaviour; with an explicit fanout, ``max_ranges``
        defaults to ``delta_range_budget`` so one gossip tick has bounded
        wire/compute cost.  Converged pairs cost one digest compare and
        move zero payload bytes either way.
        """
        ids = list(self.nodes)
        n = len(ids)
        if n < 2:
            return []
        k = n - 1 if fanout is None else max(1, min(fanout, n - 1))
        if fanout is not None and max_ranges is None:
            max_ranges = self.delta_range_budget
        step = self._gossip_step
        self._gossip_step += 1
        stats = []
        for a in ids:
            for b in self.gossip_peers(a, k, step):
                if self.network.reachable(a, b):
                    stats.append(self.delta_antientropy(
                        a, b, use_kernel=use_kernel, max_ranges=max_ranges))
        return stats

    # -- introspection ----------------------------------------------------------
    def siblings(self, key: str) -> Dict[str, int]:
        return {n: len(node.versions(key)) for n, node in self.nodes.items()}

    def metadata_size(self, key: str) -> Dict[str, int]:
        return {n: node.metadata_size(key) for n, node in self.nodes.items()}

    def all_values(self, key: str):
        out = set()
        for node in self.nodes.values():
            out |= {v.value for v in node.versions(key)}
        return frozenset(out)
