"""Geo-replication plane: DC topology, HLC frontiers, causal snapshots.

This is the store's second consistency level (DESIGN.md §12).  The quorum
plane is intra-datacenter: reads and writes assemble quorums
wherever replicas live, which across a WAN means paying cross-DC round
trips.  The geo plane splits the cluster into *datacenters* of equal size
and serves a different contract per direction:

* **Writes** commit against the coordinator's *local* DC only (the write
  quorum is scoped to same-DC replicas), then ship cross-DC asynchronously
  — one digest-diffed delta round per WAN link per shipping tick, between
  *mirror* nodes (slot i of DC A pairs with slot i of DC B; placement rows
  are mirror-expanded, so mirrors own identical key sets and the
  delta machinery applies unchanged, per shard when ``shards > 1``).
* **Snapshot reads** (``KVCluster.snapshot_get*``) are served entirely
  from the local DC with zero WAN messages: they return every version
  whose wall falls at or below the DC's **Global Stable Frontier** — the
  Okapi/GentleRain stabilization point, made skew-robust by minting
  ``Version.wall`` from per-node hybrid logical clocks
  (``version.HybridClock``).  Results are causally consistent: walls of
  causally ordered writes are ordered (coordinators fold the read
  watermark ``CausalContext.hlc`` and their own wall-column high-water
  mark into the HLC before minting), so no version is returned whose
  causal predecessor is still invisible.

The frontier for DC *d* folds, in one pass:

1. the min over **all** nodes' HLC readings (heartbeat-advanced to the
   shared physical clock) — nothing below it can still be minted;
2. the min wall across in-flight ``("store", ...)`` messages addressed to
   members of *d* (intra-DC replication still queued, plus cross-DC
   read-repair pushes);
3. the min over the **WAN backlog** into *d*: walls committed in another
   DC and not yet covered by a completed shipping tick on that link;
4. the min over the **drop backlog**: walls whose local replication send
   failed outright (partition), cleared when a delta round covers the
   failed edge.

Each node feeds (1) via max-reduces over its packed wall column
(``PackedVersionStore.max_wall`` is the incrementally-folded column max),
and the result is clamped monotone.  The invariant the fold maintains is
deliberately one-sided: every version with wall ≤ frontier is held by *at
least one* local member (the coordinator's mirror receives it on the
first completed tick), which is why snapshot reads merge across **all**
local replicas of a key — and why they require all of them reachable.

Version stores are not multiversioned, so a version still *visible* at
the frontier can be displaced from the live set by an unstable dominator
(wall > frontier).  The plane keeps a bounded per-(node, key) **stable
shadow**: backends invoke ``shadow_hook(key, before_set)`` whenever a
non-empty live set changes, and displaced sets are retained until every
member is dominated by a live version at or below the frontier
(GentleRain's retention rule), then pruned.  Both backends drive the same
hook from their single mutation choke points, so snapshot results stay
packed==object conformant by construction.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, Mapping, Optional, \
    Sequence, Tuple

from .version import HLC_EPS, Version, sync_versions

#: Shadow sets retained per (node, key) before an append forces a prune
#: against the last computed frontier (reads prune with a fresh one).
SHADOW_DEPTH = 8


def _inner_payload(message_payload: Any) -> Any:
    """Unwrap a ``("store", payload)`` message body (the only message kind
    the fabric carries)."""
    if isinstance(message_payload, tuple) and len(message_payload) == 2:
        return message_payload[1]
    return message_payload


def _payload_wall_bounds(payload: Any) -> Tuple[Optional[float],
                                                Optional[float]]:
    """(min, max) wall carried by a replication payload — ``None`` when it
    carries no versions.  Packed payloads answer from their wall column;
    object payloads scan their version sets."""
    wall = getattr(payload, "wall", None)
    if wall is not None:
        if len(wall) == 0:
            return None, None
        return float(wall.min()), float(wall.max())
    if isinstance(payload, Mapping):
        walls = [v.wall for vs in payload.values() for v in vs]
        if not walls:
            return None, None
        return min(walls), max(walls)
    return None, None


class GeoPlane:
    """Datacenter bookkeeping bolted onto one ``KVCluster``.

    Owns the DC maps (node → DC, mirror rows), the WAN/drop backlogs the
    frontier folds, the per-(node, key) stable shadows, and the
    ``WanShipper`` that runs the per-link delta shipping loop on the
    SimNetwork timer heap.  Constructed by ``KVCluster(datacenters=...)``
    — not user-instantiated.
    """

    def __init__(self, cluster, datacenters: Mapping[str, Sequence[str]],
                 *, wan_period: float = 25.0, autostart: bool = True):
        if len(datacenters) < 2:
            raise ValueError("geo mode needs at least two datacenters")
        self.cluster = cluster
        self.dcs: Dict[str, Tuple[str, ...]] = {
            dc: tuple(nodes) for dc, nodes in datacenters.items()}
        self.dc_names: Tuple[str, ...] = tuple(self.dcs)
        sizes = {len(v) for v in self.dcs.values()}
        if len(sizes) != 1 or 0 in sizes:
            raise ValueError(
                "datacenters must be equal-sized and non-empty (mirror "
                f"placement), got sizes {sorted(len(v) for v in self.dcs.values())}")
        self.dc_size = len(next(iter(self.dcs.values())))
        self.dc_of: Dict[str, str] = {}
        self._mirrors: Dict[str, Tuple[str, ...]] = {}
        for dc, nodes in self.dcs.items():
            for i, n in enumerate(nodes):
                if n in self.dc_of:
                    raise ValueError(f"node {n!r} appears in two datacenters")
                self.dc_of[n] = dc
        if set(self.dc_of) != set(cluster.nodes):
            raise ValueError("datacenters must cover exactly the cluster's "
                             "node set")
        for i in range(self.dc_size):
            row = tuple(self.dcs[dc][i] for dc in self.dc_names)
            for n in row:
                self._mirrors[n] = row
        # the ring is built over the first DC's nodes; placement rows are
        # mirror-expanded so every DC owns an identical copy of key space
        self.canonical_nodes: Tuple[str, ...] = self.dcs[self.dc_names[0]]

        net = cluster.network
        for n, dc in self.dc_of.items():
            net.set_datacenter(n, dc)

        # frontier inputs (module docstring, terms 3 and 4)
        self.wan_backlog: Dict[Tuple[str, str], List[float]] = {}
        self.drop_backlog: Dict[Tuple[str, str], List[float]] = {}
        self._frontier_cache: Dict[str, float] = {}

        # stable shadows: node → key → [displaced version sets]
        self.shadow: Dict[str, Dict[str, List[FrozenSet[Version]]]] = {}
        for n, node in cluster.nodes.items():
            node.backend.shadow_hook = \
                (lambda key, before, _n=n: self._note_displaced(
                    _n, key, before))

        # shipping accounting (the geo benchmark's WAN wire meter)
        self.wan_ticks = 0
        self.wan_rounds = 0
        self.ship_digest_bytes = 0
        self.ship_payload_bytes = 0
        self.ship_payload_slots = 0

        from .gossip import WanShipper
        self.shipper = WanShipper(self, period=wan_period,
                                  autostart=autostart)

    # -- topology ----------------------------------------------------------

    def mirrors(self, node: str) -> Tuple[str, ...]:
        """``node``'s mirror row: the same ring slot in every DC (itself
        included), ordered by DC declaration order."""
        return self._mirrors[node]

    def links(self) -> List[Tuple[str, str]]:
        """All directed WAN links, in DC declaration order."""
        return [(a, b) for a in self.dc_names for b in self.dc_names
                if a != b]

    def members(self, dc: str) -> Tuple[str, ...]:
        return self.dcs[dc]

    # -- commit-path bookkeeping (called by KVCluster) ---------------------

    def on_commit(self, src_dc: str, walls: Sequence[float]) -> None:
        """Writes committed in ``src_dc``: their walls join the WAN backlog
        of every other DC until a shipping tick on that link completes."""
        for dc in self.dc_names:
            if dc != src_dc:
                self.wan_backlog.setdefault((src_dc, dc), []).extend(walls)

    def note_send_failed(self, src: str, dst: str, wall: float) -> None:
        """A local replication send failed outright (partition/down peer):
        the wall stays a frontier obligation for ``dst``'s DC until a
        delta round covers the ``src → dst`` edge."""
        self.drop_backlog.setdefault((src, dst), []).append(wall)

    def note_delta_round(self, src: str, dst: str) -> None:
        """A completed anti-entropy round ``src → dst``: everything ``src``
        held is now at ``dst``, so drop-backlog entries for that edge are
        discharged, and ``dst``'s HLC observes its new column max."""
        self.drop_backlog.pop((src, dst), None)
        self.cluster.hlc[dst].observe(self.cluster.nodes[dst].max_wall)

    def note_receive(self, dst: str, message_payload: Any) -> None:
        """A replication message arrived at ``dst``: its HLC observes the
        payload's max wall (keeps frontier term 1 fresh without waiting
        for the next mint at ``dst``)."""
        _, top = _payload_wall_bounds(_inner_payload(message_payload))
        if top is not None:
            self.cluster.hlc[dst].observe(top)

    # -- WAN shipping ------------------------------------------------------

    def wan_tick(self, src_dc: str, dst_dc: str, *,
                 max_ranges=None, use_kernel: bool = True
                 ) -> Tuple[list, bool]:
        """One shipping tick on the ``src_dc → dst_dc`` link: a digest-
        diffed delta round per mirror slot pair (mirrors own identical key
        sets, so slot-pair rounds cover the whole key space — per shard,
        via the ordinary sharded delta machinery).  Returns ``(stats,
        complete)``; only a *complete* tick (every slot pair reachable and
        synced) discharges the link's WAN backlog — the coordinator of
        every backlogged write synced its mirror, so each shipped version
        now has at least one holder in ``dst_dc``, which is all the
        frontier invariant needs (snapshot reads merge all local members).
        """
        c = self.cluster
        pending = self.wan_backlog.get((src_dc, dst_dc))
        stats = []
        complete = True
        self.wan_ticks += 1
        for a, b in zip(self.dcs[src_dc], self.dcs[dst_dc]):
            if not c.network.reachable(a, b):
                complete = False
                continue
            st = c.delta_antientropy(a, b, max_ranges=max_ranges,
                                     use_kernel=use_kernel)
            stats.append(st)
            self.wan_rounds += 1
            self.ship_digest_bytes += st.digest_bytes
            self.ship_payload_bytes += st.payload_bytes
            self.ship_payload_slots += st.payload_slots
        if complete and pending:
            del pending[:]
        return stats, complete

    def wan_round(self, **kw) -> list:
        """One tick on every WAN link (the hand-cranked/quiesce form of
        what ``WanShipper`` runs continuously)."""
        out = []
        for a, b in self.links():
            out.extend(self.wan_tick(a, b, **kw)[0])
        return out

    @property
    def ship_bytes(self) -> int:
        return self.ship_digest_bytes + self.ship_payload_bytes

    # -- the Global Stable Frontier ----------------------------------------

    def stable_frontier(self, dc: str) -> float:
        """The DC's stabilization point: every version with wall ≤ frontier
        is visible to a snapshot read in ``dc`` (held by at least one local
        replica of its key, with its causal predecessors likewise visible).
        One fold over the four obligation sources in the module docstring,
        clamped monotone."""
        c = self.cluster
        pt = int(c.clock_time)
        for h in c.hlc.values():
            h.observe_physical(pt)
        f = min(h.read() for h in c.hlc.values())
        members = set(self.dcs[dc])
        for m in c.network.queue:
            if m.dst in members:
                low, _ = _payload_wall_bounds(_inner_payload(m.payload))
                if low is not None:
                    f = min(f, low - HLC_EPS)
        for (_, d), walls in self.wan_backlog.items():
            if d == dc and walls:
                f = min(f, min(walls) - HLC_EPS)
        for (_, d), walls in self.drop_backlog.items():
            if d in members and walls:
                f = min(f, min(walls) - HLC_EPS)
        f = max(f, self._frontier_cache.get(dc, 0.0))
        self._frontier_cache[dc] = f
        return f

    def frontier_lag(self, dc: str) -> float:
        """Staleness: how far (in clock ticks) the DC's frontier trails
        the shared physical clock."""
        return max(0.0, self.cluster.clock_time - self.stable_frontier(dc))

    # -- stable shadows ----------------------------------------------------

    def _note_displaced(self, node: str, key: str,
                        before: FrozenSet[Version]) -> None:
        lst = self.shadow.setdefault(node, {}).setdefault(key, [])
        lst.append(before)
        if len(lst) > SHADOW_DEPTH:
            # bound growth against the last frontier this plane computed
            # (0.0 before any snapshot read: keep everything — safe, and
            # reads prune with a fresh frontier anyway)
            self.prune_shadow(
                node, key,
                self._frontier_cache.get(self.dc_of[node], 0.0))

    def prune_shadow(self, node: str, key: str, frontier: float) -> None:
        """Drop shadow sets whose every member is (equal to or) dominated
        by a live version at or below ``frontier`` — any present or future
        snapshot read will see the dominator, so the set contributes
        nothing (frontiers are monotone)."""
        by_key = self.shadow.get(node)
        lst = by_key.get(key) if by_key else None
        if not lst:
            return
        live = self.cluster.nodes[node].versions(key)
        by_key[key] = [s for s in lst
                       if not self._stabilized(s, live, frontier)]

    @staticmethod
    def _stabilized(shadow_set: FrozenSet[Version],
                    live: FrozenSet[Version], frontier: float) -> bool:
        for v in shadow_set:
            if not any(w.wall <= frontier
                       and (w.clock == v.clock or v.clock.lt(w.clock))
                       for w in live):
                return False
        return True

    # -- snapshot reads ----------------------------------------------------

    def snapshot_members(self, dc: str, key: str) -> List[str]:
        """The local-DC replicas of ``key`` (mirror rows make this exactly
        ``replication`` nodes)."""
        return [r for r in self.cluster.replicas_for(key)
                if self.dc_of[r] == dc]

    def snapshot_versions(self, dc: str, key: str, frontier: float,
                          members: Optional[Sequence[str]] = None
                          ) -> FrozenSet[Version]:
        """The key's causally consistent snapshot at ``frontier``: pool the
        live sets and stable shadows of every local member, keep versions
        at or below the frontier, reduce to the maximal antichain.  Zero
        network traffic — everything read is DC-local."""
        c = self.cluster
        if members is None:
            members = self.snapshot_members(dc, key)
        pool = set()
        for m in members:
            self.prune_shadow(m, key, frontier)
            pool |= c.nodes[m].versions(key)
            by_key = self.shadow.get(m)
            if by_key:
                for s in by_key.get(key, ()):
                    pool |= s
        visible = frozenset(v for v in pool if v.wall <= frontier)
        return sync_versions(
            visible, frozenset(),
            total_order=not c.mechanism.tracks_concurrency)

    # -- admission ---------------------------------------------------------

    def check_snapshot(self, proxy: str, key: str) -> Optional[str]:
        """Why a snapshot read for ``key`` via ``proxy`` would fail right
        now, or ``None`` if it is admissible.  The frontier only promises
        *some* local member holds each stable version, so the read needs
        every local replica of the key reachable from the proxy — WAN
        cuts never trip this (the whole point), intra-DC faults do."""
        if proxy in self.cluster.network.down:
            return f"proxy {proxy} is down"
        dc = self.dc_of[proxy]
        for r in self.snapshot_members(dc, key):
            if not self.cluster.network.reachable(proxy, r):
                return (f"local replica {r} unreachable from {proxy} "
                        f"(snapshot reads merge all {dc!r} members)")
        return None

    def __repr__(self) -> str:      # pragma: no cover
        return (f"<GeoPlane dcs={list(self.dc_names)} size={self.dc_size} "
                f"ticks={self.wan_ticks} ship={self.ship_bytes}B>")


__all__ = ["GeoPlane", "SHADOW_DEPTH"]
