"""Continuous, membership-aware gossip: the anti-entropy control loop.

``KVCluster.delta_antientropy_round`` gives one *hand-cranked*
digest-diffed push round; production anti-entropy is a loop that never
stops while the replica set itself churns.  ``GossipDriver`` closes that
loop off **simulated time** (GentleRain-style scheduling: rounds are tied
to ``SimNetwork.advance``, not wall clocks):

* **Per-node timers, seeded jitter** — every node owns an independent
  next-fire timer on the SimNetwork heap; fire times are jittered by a
  per-node ``random.Random(f"{seed}:{node}")`` stream so cadences desync
  without losing determinism (same seed ⇒ identical fire schedule).
* **Divergence-adaptive budgets** (the Okapi lesson: availability under
  failure hinges on anti-entropy cost tracking *observed* divergence, not
  a fixed cadence).  Each node's interval, ``fanout`` and ``max_ranges``
  budget adapt to its own ``DeltaSyncStats``: ticks whose digests all
  agree back the interval off multiplicatively (idle gossip decays to a
  cheap heartbeat of digest roots) and decay ramped budgets; divergent
  ticks snap the interval back to the base period; ticks that *saturate*
  the range budget (more divergent buckets than the cap let travel)
  double the budget and, at the cap, widen fanout — catch-up cost rises
  to meet a divergence spike, then decays away after it.
* **Churn-proof sampling** — peers come from ``KVCluster.gossip_peers``,
  which reads *current* membership at every tick: departed nodes drop
  out of the rotation naturally, joiners are picked up lazily (each fire
  arms timers for any node it has not seen), and a fire for a node that
  was removed is a no-op that disarms itself.  Down nodes stay armed at
  the base period so recovery resumes gossip without external help.

The driver is deliberately *pure control plane*: all data movement is the
existing two-phase delta round (digest exchange → ranked divergent ranges
→ sliced ``payload(key_ranges=...)`` apply), so everything the store layer
guarantees about those rounds (byte-identical to full rounds, bounded by
divergence) holds under the driver too.  See DESIGN.md §8.

``use_kernel`` defaults to ``True`` in both drivers, as on the port's
cluster: every round sweeps survival on ``cluster.device`` (the CUDA
kernel on "cuda", its plain torch version on "cpu"); ``use_kernel=False``
asks for the numpy twin.  The JAX package's drivers default to ``False``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .bulk import DeltaSyncStats
from .cluster import KVCluster


@dataclass
class NodeGossip:
    """Per-node adaptive scheduling state (all simulated-time units)."""

    interval: float               # current fire period (adapts)
    fanout: int                   # peers pushed to per tick (adapts)
    max_ranges: int               # per-push range budget (adapts)
    rng: random.Random            # seeded per-node jitter stream
    step: int = 0                 # rotation counter for gossip_peers
    timer: Optional[int] = None   # armed SimNetwork timer id
    fire_at: float = 0.0          # when that timer is due
    ticks: int = 0
    idle_ticks: int = 0           # consecutive all-converged ticks
    incarnation: int = 0          # process lifetime this state belongs to
    # Sharded clusters: per-shard budget overrides for shards whose rounds
    # saturated — a hot shard ramps alone, cold shards keep the base
    # budget, and idle ticks decay entries back out of the map.
    shard_ranges: Dict[int, int] = field(default_factory=dict)


class GossipDriver:
    """Runs delta anti-entropy continuously off ``SimNetwork`` time.

    Construct it over a cluster and ``network.advance(dt)`` (or
    ``driver.run_for(dt)``) does the rest: timers fire, nodes push deltas
    to rotating peer samples, budgets adapt, membership changes are picked
    up.  ``stop()`` cancels all timers (the driver can be restarted with
    ``start()``).
    """

    def __init__(self, cluster: KVCluster, *, period: float = 10.0,
                 max_period: Optional[float] = None, backoff: float = 1.6,
                 jitter: float = 0.25, fanout: int = 1, max_fanout: int = 3,
                 max_ranges: Optional[int] = None,
                 max_ranges_cap: int = 1024, adapt: bool = True,
                 deliver: bool = True, use_kernel: bool = True,
                 seed: Optional[int] = None, autostart: bool = True):
        if period <= 0:
            raise ValueError("period must be positive")
        if not 0 <= jitter < 1:
            # jitter >= 1 can yield zero/negative delays — a zero-delay
            # self-re-arming timer livelocks SimNetwork.advance
            raise ValueError("jitter must be in [0, 1)")
        if backoff < 1:
            raise ValueError("backoff must be >= 1")
        self.cluster = cluster
        self.period = float(period)
        self.max_period = float(max_period if max_period is not None
                                else 8.0 * period)
        if self.max_period < self.period:
            raise ValueError("max_period must be >= period")
        self.backoff = backoff
        self.jitter = jitter
        self.fanout = max(1, fanout)
        self.max_fanout = max(self.fanout, max_fanout)
        self.base_ranges = (cluster.delta_range_budget
                            if max_ranges is None else max_ranges)
        self.max_ranges_cap = max(self.base_ranges, max_ranges_cap)
        self.adapt = adapt
        self.deliver = deliver
        self.use_kernel = use_kernel
        self.seed = cluster.seed if seed is None else seed
        self._state: Dict[str, NodeGossip] = {}
        self._running = False
        # aggregate accounting (the churn benchmark's wire/round meter)
        self.ticks = 0
        self.rounds = 0
        self.digest_bytes = 0
        self.payload_bytes = 0
        self.payload_slots = 0
        self.fallbacks = 0
        self.divergent_ticks = 0
        self.suspect_probes = 0
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        net = self.cluster.network
        if self._on_topology not in net.topology_listeners:
            net.topology_listeners.append(self._on_topology)
        self._adopt_new_nodes()
        # restart path: re-arm known nodes whose timers stop() cancelled
        for node, st in list(self._state.items()):
            if node in self.cluster.nodes and st.timer is None:
                self._arm(node)

    def stop(self) -> None:
        self._running = False
        net = self.cluster.network
        if self._on_topology in net.topology_listeners:
            net.topology_listeners.remove(self._on_topology)
        for st in self._state.values():
            if st.timer is not None:
                self.cluster.network.cancel(st.timer)
                st.timer = None

    def run_for(self, duration: float) -> None:
        """Advance simulated time, firing gossip along the way."""
        self.cluster.network.advance(duration)

    def run_until(self, t: float) -> None:
        """Advance to absolute simulated time ``t`` (no-op if in the
        past).  Gossip timers, scheduler flush deadlines and workload
        think-timers all live on the one SimNetwork heap, so any driver
        advancing the shared clock fires all of them in deterministic
        ``(fire_at, seq)`` order — the serving engine's interleave."""
        self.cluster.network.run_until(t)

    # -- scheduling --------------------------------------------------------

    def _adopt_new_nodes(self) -> None:
        """Arm timers for any cluster node the driver has not seen yet —
        how joiners enter the loop without the cluster knowing about us —
        and prune state of departed nodes (normally their own fire
        self-prunes, but a removal while the driver is stopped leaves a
        stale disarmed entry that would shadow a later re-join).

        State is also re-seeded when a node's *incarnation* changed — a
        warm restart (or a remove + re-add the driver never witnessed)
        means the adapted cadence/budgets and consumed jitter stream died
        with the old process; carrying them over would give the new
        process another process's schedule."""
        incarnation = getattr(self.cluster, "incarnation", {})
        for node in [n for n in self._state
                     if n not in self.cluster.nodes]:
            st = self._state.pop(node)
            if st.timer is not None:
                self.cluster.network.cancel(st.timer)
        for node in self.cluster.nodes:
            inc = incarnation.get(node, 0)
            st = self._state.get(node)
            if st is not None and st.incarnation != inc:
                if st.timer is not None:
                    self.cluster.network.cancel(st.timer)
                self._state.pop(node)
                st = None
            if st is None:
                self._state[node] = NodeGossip(
                    interval=self.period, fanout=self.fanout,
                    max_ranges=self.base_ranges,
                    rng=random.Random(f"{self.seed}:{node}"),
                    incarnation=inc)
                self._arm(node)

    def _arm(self, node: str, interval: Optional[float] = None) -> None:
        if not self._running:
            return
        st = self._state[node]
        base = st.interval if interval is None else interval
        delay = base * (1.0 + self.jitter * (2.0 * st.rng.random() - 1.0))
        st.timer = self.cluster.network.schedule(
            delay, lambda: self._fire(node))
        st.fire_at = self.cluster.network.now + delay

    def _wake(self, node: str) -> None:
        """Divergence wake-up: a round just proved ``node`` holds (or
        lacks) state its peer does not — snap its cadence back to the base
        period so reconciliation propagates at gossip speed instead of
        waiting out a backed-off timer.  Only ever *shortens* the wait, so
        repeated wakes cannot starve a node of its own fires."""
        st = self._state.get(node)
        if st is None or node not in self.cluster.nodes:
            return
        # Suspicion backoff (DESIGN.md §13): never snap cadences FOR a
        # suspect.  A flapping link fires topology wakes on every toggle;
        # without this filter each flap re-arms full-rate gossip toward a
        # peer the failure detector already distrusts — the wire-cost
        # difference the faults benchmark measures.
        mem = self.cluster.membership
        if mem is not None and mem.is_suspect(node,
                                              self.cluster.network.now):
            return
        st.interval = self.period
        st.idle_ticks = 0
        horizon = self.period * (1.0 + self.jitter)
        if st.timer is not None and \
                st.fire_at - self.cluster.network.now > horizon:
            self.cluster.network.cancel(st.timer)
            self._arm(node)

    def _on_topology(self) -> None:
        """Topology changed (join/partition/heal/fail/recover/depart):
        adopt any joiner immediately, and — when adapting — snap every
        backed-off cadence to the base period, since a healed link or a
        new member may be hiding fresh divergence.  Converged nodes pay
        one extra digest round and back straight off again."""
        if not self._running:
            return
        self._adopt_new_nodes()
        if not self.adapt:
            return
        for node in list(self._state):
            self._wake(node)

    def _fire(self, node: str) -> None:
        st = self._state.get(node)
        if st is None:
            return
        st.timer = None
        if node not in self.cluster.nodes:      # departed: disarm for good
            del self._state[node]
            return
        self._adopt_new_nodes()
        self.ticks += 1
        st.ticks += 1
        if self.deliver:
            # drain replication messages due by now — the driver doubles as
            # the cluster's background delivery pump
            self.cluster.deliver_replication(until=self.cluster.network.now)
        if node in self.cluster.network.down:
            # a down node cannot push; stay armed at the base period so
            # gossip resumes by itself on recovery
            self._arm(node, self.period)
            return
        rounds = []
        budget = st.max_ranges
        if st.shard_ranges and self.cluster.shards > 1:
            # ramped shards carry their own budget; the rest ride the base
            budget = {s: st.shard_ranges.get(s, st.max_ranges)
                      for s in range(self.cluster.shards)}
        # Suspicion steering (DESIGN.md §13): suspects leave this node's
        # regular rotation (skipped, never resampled — the seeded schedule
        # is untouched) and instead receive ONE dedicated base-budget
        # probe round per fire, aimed at the most-suspect reachable
        # member.  A suspect that is merely slow gets focused catch-up
        # attention; a genuinely dead one costs a reachability check, not
        # a round.
        mem = self.cluster.membership
        now = self.cluster.network.now
        suspects = frozenset(
            s for s in mem.suspect_nodes(now) if s != node) \
            if mem is not None else frozenset()
        for peer, r in self.cluster.gossip_tick(
                node, step=st.step, fanout=st.fanout,
                max_ranges=budget, use_kernel=self.use_kernel,
                exclude=suspects):
            rounds.append(r)
            if self.adapt and (r.buckets_divergent or r.changed):
                self._wake(peer)     # it knows it differs too: drain fast
        if suspects:
            probeable = [s for s in suspects
                         if s in self.cluster.nodes
                         and self.cluster.network.reachable(node, s)]
            if probeable:
                target = max(probeable,
                             key=lambda s: (mem.suspicion(s, now), s))
                rounds.append(self.cluster.delta_antientropy(
                    node, target, use_kernel=self.use_kernel,
                    max_ranges=self.base_ranges))
                self.suspect_probes += 1
        st.step += 1
        self._account(rounds)
        if self.adapt:
            self._adapt(st, rounds)
        self._arm(node)

    # -- adaptation --------------------------------------------------------

    def _account(self, rounds: Sequence[DeltaSyncStats]) -> None:
        self.rounds += len(rounds)
        for r in rounds:
            self.digest_bytes += r.digest_bytes
            self.payload_bytes += r.payload_bytes
            self.payload_slots += r.payload_slots
            if r.fallback:
                self.fallbacks += 1

    def _adapt(self, st: NodeGossip, rounds: Sequence[DeltaSyncStats]
               ) -> None:
        """Backoff when digests agree; snap back and ramp budgets when the
        observed divergence says one tick's budget was not enough.

        A fallback round that changed nothing is *convergence* evidence —
        object backends run every round as a full-payload fallback, and
        treating bare ``fallback`` as divergence would pin their cadence
        at the base period forever (full-store payloads per tick on an
        idle cluster).  The unreconcilable value-root case likewise backs
        off rather than re-shipping the store at full speed; the rounds
        keep reporting ``fallback=True`` for observability."""
        divergent = any(r.buckets_divergent > 0 or r.changed > 0
                        for r in rounds)
        # Saturation is judged where the budget was actually applied: a
        # sharded round reports per-shard stats, and only the hot shard's
        # budget ramps — its neighbours keep paying the base price.
        saturated = False
        for r in rounds:
            if r.per_shard:
                for p in r.per_shard:
                    used = st.shard_ranges.get(p.shard, st.max_ranges)
                    if p.buckets_sent >= used \
                            and p.buckets_divergent > p.buckets_sent:
                        if used < self.max_ranges_cap:
                            st.shard_ranges[p.shard] = min(
                                2 * used, self.max_ranges_cap)
                        else:
                            saturated = True   # at cap: widen fanout below
            elif r.buckets_sent >= st.max_ranges \
                    and r.buckets_divergent > r.buckets_sent:
                saturated = True
        if divergent:
            self.divergent_ticks += 1
            st.idle_ticks = 0
            st.interval = self.period
            if saturated:
                if st.max_ranges < self.max_ranges_cap:
                    st.max_ranges = min(2 * st.max_ranges,
                                        self.max_ranges_cap)
                else:                    # budget already maxed: go wider
                    st.fanout = min(st.fanout + 1, self.max_fanout)
        else:
            st.idle_ticks += 1
            st.interval = min(st.interval * self.backoff, self.max_period)
            # ramped budgets decay back toward the configured base
            st.max_ranges = max(self.base_ranges, st.max_ranges // 2)
            for s in list(st.shard_ranges):
                nxt = st.shard_ranges[s] // 2
                if nxt <= self.base_ranges:
                    del st.shard_ranges[s]
                else:
                    st.shard_ranges[s] = nxt
            if st.fanout > self.fanout:
                st.fanout -= 1

    # -- introspection -----------------------------------------------------

    def wire_bytes(self) -> int:
        """Total gossip wire cost so far (digest phase + payload phase)."""
        return self.digest_bytes + self.payload_bytes

    def node_state(self, node: str) -> NodeGossip:
        return self._state[node]

    def intervals(self) -> Dict[str, float]:
        return {n: st.interval for n, st in self._state.items()
                if n in self.cluster.nodes}

    def __repr__(self) -> str:
        return (f"<GossipDriver nodes={len(self._state)} ticks={self.ticks} "
                f"rounds={self.rounds} wire={self.wire_bytes()}B>")


@dataclass
class LinkState:
    """Per-WAN-link shipping cadence (all simulated-time units)."""

    interval: float
    rng: random.Random
    timer: Optional[int] = None
    fire_at: float = 0.0
    ticks: int = 0


class WanShipper:
    """The geo tier's cross-DC loop: per-WAN-link delta shipping timers on
    the same SimNetwork heap the LAN ``GossipDriver`` runs on.

    One link = one directed DC pair; a fire runs ``GeoPlane.wan_tick``
    (digest-diffed mirror slot-pair rounds, O(divergence) on the wire) and
    adapts like the LAN driver in miniature: ticks that shipped nothing
    back the link's cadence off multiplicatively, divergent or incomplete
    ticks snap it to the base period, and topology changes (a healed WAN
    cut) snap every link so backlogged writes ship at loop speed instead
    of waiting out a backoff.  Constructed by ``GeoPlane``; set
    ``use_kernel`` on it to choose the sweep every tick runs (the JAX
    package's shipper always takes ``wan_tick``'s default).
    """

    def __init__(self, geo, *, period: float = 25.0,
                 max_period: Optional[float] = None, backoff: float = 1.6,
                 jitter: float = 0.25, seed: Optional[int] = None,
                 use_kernel: bool = True, autostart: bool = True):
        if period <= 0:
            raise ValueError("period must be positive")
        if not 0 <= jitter < 1:
            raise ValueError("jitter must be in [0, 1)")
        self.geo = geo
        self.cluster = geo.cluster
        self.period = float(period)
        self.max_period = float(max_period if max_period is not None
                                else 4.0 * period)
        self.backoff = backoff
        self.jitter = jitter
        self.use_kernel = use_kernel     # passed on to every wan_tick
        self.seed = self.cluster.seed if seed is None else seed
        self._state: Dict[tuple, LinkState] = {
            link: LinkState(
                interval=self.period,
                rng=random.Random(f"{self.seed}:wan:{link[0]}>{link[1]}"))
            for link in geo.links()}
        self._running = False
        self.ticks = 0
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        net = self.cluster.network
        if self._on_topology not in net.topology_listeners:
            net.topology_listeners.append(self._on_topology)
        for link, st in self._state.items():
            if st.timer is None:
                self._arm(link)

    def stop(self) -> None:
        self._running = False
        net = self.cluster.network
        if self._on_topology in net.topology_listeners:
            net.topology_listeners.remove(self._on_topology)
        for st in self._state.values():
            if st.timer is not None:
                net.cancel(st.timer)
                st.timer = None

    # -- scheduling --------------------------------------------------------

    def _arm(self, link: tuple, interval: Optional[float] = None) -> None:
        if not self._running:
            return
        st = self._state[link]
        base = st.interval if interval is None else interval
        delay = base * (1.0 + self.jitter * (2.0 * st.rng.random() - 1.0))
        st.timer = self.cluster.network.schedule(
            delay, lambda: self._fire(link))
        st.fire_at = self.cluster.network.now + delay

    def _on_topology(self) -> None:
        """A healed link (or any topology shift) may have freed a WAN
        backlog: snap every link's cadence to the base period."""
        if not self._running:
            return
        horizon = self.period * (1.0 + self.jitter)
        for link, st in self._state.items():
            st.interval = self.period
            if st.timer is not None and \
                    st.fire_at - self.cluster.network.now > horizon:
                self.cluster.network.cancel(st.timer)
                self._arm(link)

    def _fire(self, link: tuple) -> None:
        st = self._state[link]
        st.timer = None
        st.ticks += 1
        self.ticks += 1
        # drain due replication first so shipped state reflects the
        # present, matching the LAN driver's delivery-pump discipline
        self.cluster.deliver_replication(until=self.cluster.network.now)
        stats, complete = self.geo.wan_tick(*link,
                                            use_kernel=self.use_kernel)
        shipped = any(r.buckets_divergent or r.changed for r in stats)
        if shipped or not complete:
            st.interval = self.period
        else:
            st.interval = min(st.interval * self.backoff, self.max_period)
        self._arm(link)

    def __repr__(self) -> str:      # pragma: no cover
        return (f"<WanShipper links={len(self._state)} ticks={self.ticks}>")


def cluster_converged(cluster: KVCluster) -> bool:
    """True iff every pair of live nodes holds identical state — digest
    trees (and value roots) for packed backends, version-set dicts for
    object backends.  The quiescence check churn tests and the benchmark
    poll between gossip ticks."""
    nodes = [cluster.nodes[n] for n in cluster.nodes
             if n not in cluster.network.down]
    if len(nodes) < 2:
        return True
    if all(n.is_packed for n in nodes):
        # compare shard by shard (one store per node at shards=1); the
        # reference node's digests are snapshotted once per shard
        refs = [(ref, ref.sync_digest(), ref.value_root())
                for ref in nodes[0].shard_stores]
        for other in nodes[1:]:
            for (_, ref_digest, ref_vroot), st in zip(refs,
                                                      other.shard_stores):
                if len(ref_digest.diff(st.sync_digest())) != 0:
                    return False
                if ref_vroot != st.value_root():
                    return False
        return True
    keys = set()
    for n in nodes:
        keys |= set(getattr(n.backend, "store", {}).keys())
    return all(n.versions(k) == nodes[0].versions(k)
               for k in keys for n in nodes[1:])


__all__ = ["GossipDriver", "LinkState", "NodeGossip", "WanShipper",
           "cluster_converged"]
