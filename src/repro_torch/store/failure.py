"""Self-driving membership: accrual failure detection wired into the loop.

The seed's ``cluster/failure_detector.py`` was a training-sim helper that
nothing in the store called — membership changes were hand-invoked, so the
paper's "bounded by the degree of replication" claim only held while an
operator watched the cluster.  This module promotes the detector to a
first-class store citizen and closes the SWIM-style loop:

* ``FailureDetector`` — per-node accrual suspicion.  A node's suspicion is
  its silence measured in *expected heartbeat intervals*; the expected
  interval adapts to the observed gap history (median of clamped gaps, so
  one long partition cannot inflate it — the Okapi/GentleRain+ lesson that
  robustness claims only hold once anomalies are injected deliberately).
  Members are registered the moment they join, so a node that joins and
  immediately goes silent is visible to the detector from its first
  missing beat.
* ``MembershipController`` — the control loop.  Per-node *probe* timers on
  the ``SimNetwork`` heap (fixed cadence, seeded jitter) record a beat
  whenever the node's gossip/acks can reach at least one live member;
  crossing ``dead_threshold`` triggers ``KVCluster.remove_node`` with
  handoff automatically (purging the fabric queue of messages addressed to
  the corpse), and an evicted node that becomes reachable again is
  re-admitted through the warm digest-diffed bootstrap.  No hand-called
  membership anywhere.

Suspicion also feeds the data plane: ``KVCluster`` deprioritizes suspect
replicas when assembling quorums and picking coordinators, and
``GossipDriver`` skips suspects in its regular rounds while aiming one
dedicated probe round per tick at the most-suspect reachable member —
suspicion *raises* a node's anti-entropy priority (it gets focused
attention) while backing regular gossip off it (a flapping peer stops
snapping every cadence in the cluster).

Determinism contract: probe fire times are pure functions of
``(seed, node)``, and a beat depends only on fabric reachability and
current membership — never on payload contents, adapted gossip cadences
or backend representation.  Eviction/re-admission times are therefore
byte-identical between the packed and object backends, which is what lets
the churn/fault conformance suites assert ``packed == object`` *including
the membership trajectory*.  See DESIGN.md §13.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FailureDetector:
    """Accrual-style failure detection over heartbeats.

    Suspicion is the normalized time since the last beat; crossing
    ``suspect_threshold`` marks the node suspect, ``dead_threshold`` lets
    the control loop declare it dead.  ``heartbeat_interval`` is the
    prior for the expected gap until a history exists.
    """

    heartbeat_interval: float = 1.0
    suspect_threshold: float = 3.0   # intervals without a beat -> suspect
    dead_threshold: float = 8.0      # intervals without a beat -> dead
    last_beat: Dict[str, float] = field(default_factory=dict)
    history: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, node: str, now: float) -> None:
        prev = self.last_beat.get(node)
        if prev is not None:
            self.history.setdefault(node, []).append(now - prev)
            # keep a bounded window for the adaptive interval estimate
            if len(self.history[node]) > 64:
                self.history[node] = self.history[node][-64:]
        self.last_beat[node] = now

    def register(self, node: str, now: float) -> None:
        """Start tracking a member that has produced no beat yet (a fresh
        join): suspicion is measured from registration.  Without this, a
        node that joins and immediately goes silent never enters
        ``last_beat`` and is invisible to ``suspects()``/``dead()``
        forever.  A no-op for already-tracked nodes."""
        if node not in self.last_beat:
            self.last_beat[node] = now

    def forget(self, node: str) -> None:
        """Drop all state for a departed node (mirrors
        ``SimNetwork.forget``).  Without it, ``last_beat``/``history``
        leak forever and a removed-then-readded node inherits stale gap
        history from its previous life."""
        self.last_beat.pop(node, None)
        self.history.pop(node, None)

    def known(self) -> List[str]:
        return list(self.last_beat)

    def _expected_interval(self, node: str) -> float:
        """Median of the observed gaps, each clamped at
        ``suspect_threshold`` intervals.  A raw mean lets one long
        partition gap inflate the estimate and suppress suspicion for
        many intervals after the heal; the clamped median forgets an
        outage as soon as regular beats resume."""
        hist = self.history.get(node)
        if not hist:
            return self.heartbeat_interval
        cap = self.suspect_threshold * self.heartbeat_interval
        gaps = sorted(min(g, cap) for g in hist)
        n = len(gaps)
        mid = n // 2
        med = gaps[mid] if n % 2 else 0.5 * (gaps[mid - 1] + gaps[mid])
        return max(med, 1e-9)

    def suspicion(self, node: str, now: float) -> float:
        """0 = just heard from it; grows linearly in missed intervals."""
        if node not in self.last_beat:
            return float("inf")
        return (now - self.last_beat[node]) / self._expected_interval(node)

    def suspects(self, now: float) -> List[str]:
        return [n for n in self.last_beat
                if self.suspect_threshold <= self.suspicion(n, now)
                < self.dead_threshold]

    def dead(self, now: float) -> List[str]:
        return [n for n in self.last_beat
                if self.suspicion(n, now) >= self.dead_threshold]

    def alive(self, now: float) -> List[str]:
        return [n for n in self.last_beat
                if self.suspicion(n, now) < self.suspect_threshold]


@dataclass
class _ProbeState:
    """Per-node probe scheduling state (all simulated-time units)."""

    rng: random.Random
    timer: Optional[int] = None


class MembershipController:
    """Closes the membership loop over a ``KVCluster`` (DESIGN.md §13).

    Construction registers the controller on the cluster
    (``cluster.membership``) and arms one probe timer per member on the
    shared ``SimNetwork`` heap.  Each fire records a beat iff the node's
    outbound traffic can currently reach at least one live member, then
    sweeps: members past ``dead_threshold`` are evicted via
    ``remove_node(handoff=...)`` (the fabric queue toward them is purged,
    their detector state forgotten, and — when the eviction hit a node
    the fault injector had crashed — the crash outlives the eviction so a
    later recovery is still required before re-admission); evicted nodes
    that became reachable again are re-admitted via ``add_node`` and the
    warm digest-diffed bootstrap.  Topology changes trigger an
    immediate sweep, so a heal re-admits at event speed rather than probe
    cadence.
    """

    def __init__(self, cluster, *, period: float = 10.0,
                 jitter: float = 0.25, suspect_threshold: float = 3.0,
                 dead_threshold: float = 8.0, min_members: int = 2,
                 handoff: bool = True, readmit: bool = True,
                 bootstrap_ranges: Optional[int] = None,
                 seed: Optional[int] = None, autostart: bool = True):
        if period <= 0:
            raise ValueError("period must be positive")
        if not 0 <= jitter < 1:
            raise ValueError("jitter must be in [0, 1)")
        if not 0 < suspect_threshold < dead_threshold:
            raise ValueError("need 0 < suspect_threshold < dead_threshold")
        if getattr(cluster, "geo", None) is not None:
            raise ValueError("self-driving membership is not supported on "
                             "a geo cluster (mirror placement is static)")
        self.cluster = cluster
        self.network = cluster.network
        self.period = float(period)
        self.jitter = jitter
        self.detector = FailureDetector(
            heartbeat_interval=self.period,
            suspect_threshold=suspect_threshold,
            dead_threshold=dead_threshold)
        self.min_members = max(min_members, 1)
        self.handoff = handoff
        self.readmit = readmit
        self.bootstrap_ranges = bootstrap_ranges
        self.seed = cluster.seed if seed is None else seed
        self._state: Dict[str, _ProbeState] = {}
        self._evicted: Dict[str, float] = {}     # node -> eviction time
        self._running = False
        self._sweeping = False
        self.probes = 0
        self.evictions = 0
        self.readmissions = 0
        cluster.membership = self
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        net = self.network
        if self._on_topology not in net.topology_listeners:
            net.topology_listeners.append(self._on_topology)
        self._adopt()
        for node, st in list(self._state.items()):
            if node in self.cluster.nodes and st.timer is None:
                self._arm(node)

    def stop(self) -> None:
        self._running = False
        net = self.network
        if self._on_topology in net.topology_listeners:
            net.topology_listeners.remove(self._on_topology)
        for st in self._state.values():
            if st.timer is not None:
                net.cancel(st.timer)
                st.timer = None

    # -- probing -----------------------------------------------------------

    def _adopt(self) -> None:
        """Track any member the controller has not seen: register it with
        the detector (suspicion measured from registration) and arm its
        probe timer.  Prune state of departed nodes and drop the eviction
        record of anything hand-re-added behind our back."""
        for node in [n for n in self._state
                     if n not in self.cluster.nodes]:
            st = self._state.pop(node)
            if st.timer is not None:
                self.network.cancel(st.timer)
        for node in self.cluster.nodes:
            self._evicted.pop(node, None)
            if node not in self._state:
                self._state[node] = _ProbeState(
                    rng=random.Random(f"{self.seed}:fd:{node}"))
                self.detector.register(node, self.network.now)
                self._arm(node)

    def _arm(self, node: str) -> None:
        if not self._running:
            return
        st = self._state[node]
        delay = self.period * (
            1.0 + self.jitter * (2.0 * st.rng.random() - 1.0))
        st.timer = self.network.schedule(delay, lambda: self._probe(node))

    def _heard(self, node: str) -> bool:
        """Would the node's outbound gossip/acks reach anyone right now?
        Pure fabric arithmetic (down set, partitions, directed link cuts)
        over current membership — deliberately independent of payloads
        and adapted gossip cadences, so membership decisions are
        byte-identical across storage backends."""
        if node in self.network.down:
            return False
        return any(self.network.reachable(node, m)
                   for m in self.cluster.nodes if m != node)

    def _probe(self, node: str) -> None:
        st = self._state.get(node)
        if st is None:
            return
        st.timer = None
        if node not in self.cluster.nodes:       # departed: disarm for good
            del self._state[node]
            return
        self._adopt()
        self.probes += 1
        now = self.network.now
        if self._heard(node):
            self.detector.record(node, now)
        self.sweep(now)
        if node in self._state:                  # not evicted by the sweep
            self._arm(node)

    def _on_topology(self) -> None:
        """Topology changed (partition/heal/cut/flap/fail/recover/join/
        depart): adopt joiners, and sweep immediately — a heal may have
        made an evicted node reachable (re-admit now, not a probe period
        later) or left a dead one finally safe to evict with handoff."""
        if not self._running:
            return
        self._adopt()
        self.sweep(self.network.now)

    # -- the membership decisions ------------------------------------------

    def sweep(self, now: float) -> None:
        """Evict members past the dead threshold, re-admit evicted nodes
        that are reachable again.  Re-entrancy guarded: evictions and
        re-admissions themselves fire topology events."""
        if self._sweeping:
            return
        self._sweeping = True
        try:
            for node in sorted(self.detector.dead(now)):
                if node in self.cluster.nodes and \
                        len(self.cluster.nodes) > self.min_members:
                    self._evict(node, now)
            if self.readmit:
                for node in sorted(self._evicted):
                    if node not in self.network.down and \
                            any(self.network.reachable(node, m)
                                for m in self.cluster.nodes):
                        self._readmit(node)
        finally:
            self._sweeping = False

    def _evict(self, node: str, now: float) -> None:
        was_down = node in self.network.down
        # remove_node rehashes placement, runs the final handoff push to
        # every *reachable* survivor (a genuinely dead node hands off
        # nothing; a falsely-suspected live one saves its sole-copy
        # writes), and purges the fabric queue of messages addressed to
        # the departed id — the leak that otherwise grows every
        # ``deliver()`` scan forever.
        self.cluster.remove_node(node, handoff=self.handoff)
        if was_down:
            # the eviction is a membership decision; the *crash* is the
            # fault injector's state and must outlive it (forget() clears
            # the down flag for planned departures)
            self.network.down.add(node)
        self.detector.forget(node)
        st = self._state.pop(node, None)
        if st is not None and st.timer is not None:
            self.network.cancel(st.timer)
        self._evicted[node] = now
        self.evictions += 1

    def _readmit(self, node: str) -> None:
        del self._evicted[node]
        if node in getattr(self.cluster, "wal", {}):
            # Durable-log recovery (DESIGN.md §14): the evicted node left a
            # segment log behind, so it rejoins *warm* — replay snapshot +
            # tail from disk, then one digest-diffed delta round for what
            # it missed — instead of paying the O(store) bootstrap.
            self.cluster.restart_node(node)
        else:
            # warm re-entry: placement rehash + ranked digest-diffed
            # bootstrap pulls (only the shards it owns, on a sharded
            # cluster)
            self.cluster.add_node(node, bootstrap=True,
                                  bootstrap_ranges=self.bootstrap_ranges)
        self.readmissions += 1

    # -- suspicion surface (the data-plane hooks) --------------------------

    def suspicion(self, node: str, now: Optional[float] = None) -> float:
        if now is None:
            now = self.network.now
        return self.detector.suspicion(node, now)

    def is_suspect(self, node: str, now: Optional[float] = None) -> bool:
        """True iff a *tracked* node's suspicion crossed the suspect
        threshold.  Unknown nodes (joiners the controller has not adopted
        yet) are not suspect — they simply have no evidence either way."""
        if node not in self.detector.last_beat:
            return False
        return self.suspicion(node, now) >= self.detector.suspect_threshold

    def suspect_nodes(self, now: Optional[float] = None) -> List[str]:
        """Current members at or past the suspect threshold (including
        dead-but-not-yet-evicted), in membership order."""
        return [n for n in self.cluster.nodes if self.is_suspect(n, now)]

    def evicted_nodes(self) -> List[str]:
        return sorted(self._evicted)

    def __repr__(self) -> str:      # pragma: no cover
        return (f"<MembershipController nodes={len(self._state)} "
                f"probes={self.probes} evictions={self.evictions} "
                f"readmissions={self.readmissions}>")


__all__ = ["FailureDetector", "MembershipController"]
