"""Deterministic simulated transport: partitions, node failures, async delivery.

The container is a single process, so "the network" is a seeded discrete
queue.  Two properties matter for reproducing the paper (and for the
fault-tolerance story of the framework):

* **Reachability** — partitions and down nodes make quorum operations fail
  or proceed degraded, which is how replica divergence arises.
* **Asynchronous replication** — coordinator→replica store messages are
  *queued*, and drivers/tests decide when (whether) they are delivered.
  Interleaving control is what exposes the causality bugs of the §3
  baselines.

Beyond symmetric partitions and crashed nodes, the fabric carries a
*fault-injection matrix* (DESIGN.md §13): directed link cuts
(``cut_link`` — A can talk to B while B cannot answer), slow-not-dead
nodes (``set_delay_factor`` — per-node latency multipliers applied
*after* the main RNG draw, so the no-fault trace is byte-identical),
seeded message duplication and reordering (``set_duplication`` /
``set_reorder`` — drawn from a dedicated ``fault_rng`` stream so
enabling them never perturbs base latency draws), and flapping links
(``flap_link`` — timer-chained up/down toggles).  These are exactly the
conditions under which accrual failure detection earns its keep, and
the conformance suite asserts packed==object under every mode.

The fabric also carries *timers* (``schedule``/``cancel``): callbacks keyed
to simulated time, fired in deterministic ``(fire_at, seq)`` order by
``advance``.  They are what lets the gossip driver (store/gossip.py) run
anti-entropy continuously off SimNetwork time instead of being hand-cranked
— simulated-clock scheduling, GentleRain-style, rather than wall time.
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set, Tuple


class Unavailable(Exception):
    """Raised when a quorum cannot be assembled (CAP: we choose AP, but a
    *strict* quorum request against a partitioned minority still fails)."""


def payload_nbytes(obj: Any) -> int:
    """Wire-size estimate of a message payload.

    Objects that know their encoding (``PackedPayload``, digest snapshots,
    ``CausalContext`` via ``to_bytes``) report it; containers recurse;
    everything else is priced at its repr — the sim-transport's
    serialization stand-in.  Keeps ``SimNetwork.bytes_sent`` honest now
    that replication messages carry encoded array payloads.
    """
    nbytes = getattr(obj, "nbytes", None)
    if callable(nbytes):
        return int(nbytes())
    to_bytes = getattr(obj, "to_bytes", None)
    if callable(to_bytes) and not isinstance(obj, int):
        try:
            return len(to_bytes())
        except TypeError:       # int.to_bytes-style signatures
            pass
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj)
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, (tuple, list, set, frozenset)):
        return sum(payload_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(payload_nbytes(k) + payload_nbytes(v)
                   for k, v in obj.items())
    return len(repr(obj).encode())


@dataclass
class Message:
    src: str
    dst: str
    payload: Any
    deliver_at: float


class SimNetwork:
    """Seeded, deterministic message fabric between named nodes."""

    def __init__(self, seed: int = 0, base_latency: float = 1.0,
                 jitter: float = 0.5, drop_rate: float = 0.0):
        self.rng = random.Random(seed)
        self.now = 0.0
        self.base_latency = base_latency
        self.jitter = jitter
        self.drop_rate = drop_rate
        self.queue: List[Message] = []
        self.partition_groups: Optional[List[Set[str]]] = None
        self.down: Set[str] = set()
        self.delivered = 0
        self.dropped = 0
        self.bytes_sent = 0
        # fault-injection matrix (DESIGN.md §13).  All state defaults off;
        # the dup/reorder draws come from a dedicated RNG stream so that
        # enabling a fault mode never shifts the main ``rng`` latency
        # sequence (trace determinism for everything else is preserved).
        self.link_cuts: Set[Tuple[str, str]] = set()      # directed (src, dst)
        self.delay_factors: Dict[str, float] = {}         # node -> multiplier
        self.dup_rate = 0.0
        self.reorder_rate = 0.0
        self.reorder_spread = 0.0
        self.fault_rng = random.Random(f"{seed}:faults")
        self.duplicated = 0
        self.reordered = 0
        self._flaps: Dict[int, Tuple[str, str]] = {}      # flap id -> link
        self._flap_seq = 0
        # datacenter topology (geo tier).  All three maps default empty, in
        # which case ``_link_params`` returns the flat (base_latency, jitter)
        # pair and ``send`` is byte-identical to the untagged fabric — same
        # arithmetic, same single RNG draw per successful send.
        self.datacenters: Dict[str, str] = {}
        self._lan_latency: Optional[Tuple[float, float]] = None
        self._wan_latency: Optional[Tuple[float, float]] = None
        self._link_overrides: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.wan_messages = 0
        self.wan_bytes = 0
        # timers: (fire_at, seq, callback) min-heap; cancellation is lazy
        # (cancelled ids are skipped when popped) so cancel is O(1)
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = 0
        self._cancelled: Set[int] = set()
        self.timers_fired = 0
        # synchronous observers of reachability changes (partition/heal/
        # fail/recover/forget) — how the gossip driver snaps backed-off
        # cadences the moment the topology shifts, the way a real
        # membership layer reacts to connection events
        self.topology_listeners: List[Callable[[], None]] = []

    # -- topology control ----------------------------------------------------
    def _topology_changed(self) -> None:
        for listener in list(self.topology_listeners):
            listener()

    def partition(self, *groups: Set[str]) -> None:
        """Split the cluster into isolated groups (None heals)."""
        self.partition_groups = [set(g) for g in groups]
        self._topology_changed()

    def heal(self) -> None:
        """Full heal: clears partitions *and* directed link cuts (active
        flaps will re-cut their link on the next down phase; use
        ``stop_flaps`` first for a durable heal)."""
        self.partition_groups = None
        self.link_cuts.clear()
        self._topology_changed()

    def cut_link(self, src: str, dst: str) -> None:
        """Cut one *directed* link: ``src`` can no longer reach ``dst``
        while ``dst -> src`` stays up — the asymmetric failure mode a
        symmetric ``partition`` cannot express (a node whose outbound
        NIC died still hears everyone)."""
        self.link_cuts.add((src, dst))
        self._topology_changed()

    def heal_link(self, src: str, dst: str) -> None:
        if (src, dst) in self.link_cuts:
            self.link_cuts.discard((src, dst))
            self._topology_changed()

    def flap_link(self, a: str, b: str, *, up_for: float, down_for: float,
                  start_down: bool = True) -> int:
        """Start a flapping link: ``a <-> b`` (both directions) toggles
        down for ``down_for`` then up for ``up_for`` simulated seconds on
        the timer heap, forever, until ``stop_flap``.  Returns a flap id.
        Flapping is the adversarial input for membership: every toggle
        fires topology listeners, so naive cadence-snapping gossip pays
        full price per flap while suspicion-driven backoff does not."""
        if up_for <= 0 or down_for <= 0:
            raise ValueError("flap phases must be positive")
        self._flap_seq += 1
        fid = self._flap_seq
        self._flaps[fid] = (a, b)

        def phase(down: bool) -> None:
            if fid not in self._flaps:      # stopped: orphan timer, no-op
                return
            if down:
                self.link_cuts.add((a, b))
                self.link_cuts.add((b, a))
            else:
                self.link_cuts.discard((a, b))
                self.link_cuts.discard((b, a))
            self._topology_changed()
            self.schedule(down_for if down else up_for,
                          lambda: phase(not down))

        phase(start_down)
        return fid

    def stop_flap(self, flap_id: int) -> None:
        """Stop one flap and heal its link (the orphaned phase timer
        becomes a no-op)."""
        link = self._flaps.pop(flap_id, None)
        if link is not None:
            a, b = link
            self.link_cuts.discard((a, b))
            self.link_cuts.discard((b, a))
            self._topology_changed()

    def stop_flaps(self) -> None:
        for fid in list(self._flaps):
            self.stop_flap(fid)

    def set_delay_factor(self, node: str, factor: float) -> None:
        """Make ``node`` slow-not-dead: every message it sends or receives
        takes ``factor``× the drawn latency.  Applied *after* the main RNG
        draw, so a factor of 1.0 (the default) leaves traces
        byte-identical.  Slow nodes stay reachable — they strain quorum
        tails and failure detection without tripping ``reachable``."""
        if factor < 0:
            raise ValueError("delay factor must be non-negative")
        if factor == 1.0:
            self.delay_factors.pop(node, None)
        else:
            self.delay_factors[node] = float(factor)

    def set_duplication(self, rate: float) -> None:
        """Duplicate each queued send with probability ``rate`` (a second
        copy with its own fault-stream latency).  Duplicates are real
        traffic: they count toward ``bytes_sent`` (and WAN accounting),
        and the store must absorb them — DVV sync is a join, so
        re-applying a payload is a no-op (idempotence tested in the fault
        suite)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError("duplication rate must be in [0, 1]")
        self.dup_rate = float(rate)

    def set_reorder(self, rate: float, spread: float = 25.0) -> None:
        """With probability ``rate``, add up to ``spread`` extra seconds of
        fault-stream latency to a send — enough to overtake later sends
        and invert delivery order (delivery remains timestamp-sorted; the
        *timestamps* are scrambled)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError("reorder rate must be in [0, 1]")
        if spread < 0:
            raise ValueError("reorder spread must be non-negative")
        self.reorder_rate = float(rate)
        self.reorder_spread = float(spread)

    def fail_node(self, node: str) -> None:
        self.down.add(node)
        self._topology_changed()

    def recover_node(self, node: str) -> None:
        self.down.discard(node)
        self._topology_changed()

    def forget(self, node: str) -> int:
        """Remove a *departed* node from the fabric: purge queued messages
        addressed TO it (no destination exists — they would retry forever)
        and drop it from the down set.  Messages it already *sent* stay
        queued — their destinations are alive, and dropping them would
        destroy acknowledged writes in flight — so the node also stays in
        any partition group as a ghost entry: stripping it would make
        those kept sends unreachable (``reachable`` finds the absent src
        in no group) until a heal.  Ghost entries are harmless for live
        pairs and vanish with the next ``partition``/``heal``.
        Returns the number of purged messages."""
        before = len(self.queue)
        self.queue = [m for m in self.queue if m.dst != node]
        self.down.discard(node)
        self._topology_changed()
        return before - len(self.queue)

    # -- datacenter topology (geo tier) --------------------------------------
    def set_datacenter(self, node: str, dc: str) -> None:
        """Tag ``node`` as living in datacenter ``dc``."""
        self.datacenters[node] = dc

    def dc_of(self, node: str) -> Optional[str]:
        return self.datacenters.get(node)

    def set_latency_classes(self, lan: Tuple[float, float],
                            wan: Tuple[float, float]) -> None:
        """Give intra-DC and cross-DC links distinct ``(base, jitter)``
        latency classes.  Links whose endpoints lack DC tags keep the flat
        default; per-link overrides beat both classes."""
        self._lan_latency = (float(lan[0]), float(lan[1]))
        self._wan_latency = (float(wan[0]), float(wan[1]))

    def set_link_latency(self, src: str, dst: str, base: float,
                         jitter: float) -> None:
        """Override one *directed* link's latency parameters (the most
        specific tier: override > DC class > flat default)."""
        self._link_overrides[(src, dst)] = (float(base), float(jitter))

    def clear_link_latency(self, src: str, dst: str) -> None:
        self._link_overrides.pop((src, dst), None)

    def _link_params(self, src: str, dst: str) -> Tuple[float, float]:
        """Resolve ``(base, jitter)`` for one directed link.  With no
        overrides, classes, or DC tags this returns the constructor pair —
        ``send`` then computes the exact expression the flat fabric always
        used, preserving byte-identical traces for untagged clusters."""
        ov = self._link_overrides.get((src, dst))
        if ov is not None:
            return ov
        if self._lan_latency is not None or self._wan_latency is not None:
            sdc = self.datacenters.get(src)
            ddc = self.datacenters.get(dst)
            if sdc is not None and ddc is not None:
                if sdc == ddc:
                    if self._lan_latency is not None:
                        return self._lan_latency
                elif self._wan_latency is not None:
                    return self._wan_latency
        return self.base_latency, self.jitter

    def is_wan(self, src: str, dst: str) -> bool:
        """True iff both endpoints are DC-tagged and the tags differ."""
        sdc = self.datacenters.get(src)
        ddc = self.datacenters.get(dst)
        return sdc is not None and ddc is not None and sdc != ddc

    def reachable(self, a: str, b: str) -> bool:
        """Can ``a`` currently get a message *to* ``b``?  Directional:
        a cut ``(a, b)`` link blocks this way while ``(b, a)`` may flow."""
        if a in self.down or b in self.down:
            return False
        if a == b:
            return True
        if (a, b) in self.link_cuts:
            return False
        if self.partition_groups is None:
            return True
        for g in self.partition_groups:
            if a in g and b in g:
                return True
        return False

    # -- messaging -------------------------------------------------------------
    def send(self, src: str, dst: str, payload: Any) -> bool:
        """Queue a message; returns False if it is dropped immediately."""
        if not self.reachable(src, dst):
            self.dropped += 1
            return False
        if self.drop_rate and self.rng.random() < self.drop_rate:
            self.dropped += 1
            return False
        base, jit = self._link_params(src, dst)
        latency = base + self.rng.random() * jit
        # fault matrix: delay factors scale the drawn latency (slow-not-
        # dead nodes); reorder adds fault-stream latency so this send can
        # be overtaken by later ones.  Both are applied after the main RNG
        # draw — with faults off, the arithmetic and the RNG stream are
        # exactly the pre-fault fabric's.
        if self.delay_factors:
            latency *= (self.delay_factors.get(src, 1.0)
                        * self.delay_factors.get(dst, 1.0))
        if self.reorder_rate and self.fault_rng.random() < self.reorder_rate:
            latency += self.fault_rng.random() * self.reorder_spread
            self.reordered += 1
        self.queue.append(Message(src, dst, payload, self.now + latency))
        nbytes = payload_nbytes(payload)
        self.bytes_sent += nbytes
        wan = self.is_wan(src, dst)
        if wan:
            self.wan_messages += 1
            self.wan_bytes += nbytes
        if self.dup_rate and self.fault_rng.random() < self.dup_rate:
            dup_latency = base + self.fault_rng.random() * jit
            if self.delay_factors:
                dup_latency *= (self.delay_factors.get(src, 1.0)
                                * self.delay_factors.get(dst, 1.0))
            self.queue.append(
                Message(src, dst, payload, self.now + dup_latency))
            self.duplicated += 1
            self.bytes_sent += nbytes       # duplicates cost real wire
            if wan:
                self.wan_messages += 1
                self.wan_bytes += nbytes
        return True

    def deliver(self, handler: Callable[[Message], None],
                until: Optional[float] = None,
                max_messages: Optional[int] = None) -> int:
        """Deliver queued messages in timestamp order (stable, deterministic).

        Messages to currently-unreachable destinations stay queued (they
        will flow once the partition heals — this models TCP retry /
        hinted handoff).
        """
        count = 0
        while True:
            ready = [m for m in self.queue
                     if (until is None or m.deliver_at <= until)
                     and self.reachable(m.src, m.dst)]
            if not ready or (max_messages is not None and count >= max_messages):
                break
            ready.sort(key=lambda m: (m.deliver_at, m.src, m.dst))
            msg = ready[0]
            self.queue.remove(msg)
            self.now = max(self.now, msg.deliver_at)
            handler(msg)
            count += 1
            self.delivered += 1
        return count

    def pending(self) -> int:
        return len(self.queue)

    def queued_for(self, node: str) -> int:
        """Messages queued toward ``node`` — the churn suite's leak probe:
        after a control-loop eviction this must be zero (``forget`` purges
        sends to a destination that no longer exists)."""
        return sum(1 for m in self.queue if m.dst == node)

    # -- timers (simulated-clock scheduling) -----------------------------------
    def schedule(self, delay: float, callback: Callable[[], None]) -> int:
        """Arm ``callback`` to fire ``delay`` simulated seconds from now.
        Returns a timer id for ``cancel``.  Callbacks run inside ``advance``
        and may schedule further timers (the re-arming gossip pattern)."""
        self._timer_seq += 1
        heapq.heappush(self._timers,
                       (self.now + max(0.0, delay), self._timer_seq, callback))
        return self._timer_seq

    def schedule_at(self, fire_at: float, callback: Callable[[], None]) -> int:
        """Arm ``callback`` at *absolute* simulated time ``fire_at`` (past
        times fire on the next ``advance``).  The op-scheduler flush hook:
        deadlines are points on the shared clock, not relative delays."""
        return self.schedule(fire_at - self.now, callback)

    def cancel(self, timer_id: int) -> None:
        self._cancelled.add(timer_id)

    def next_timer_due(self) -> Optional[float]:
        """Earliest live timer deadline, or ``None`` — how an event loop
        steps straight to the next interesting instant instead of polling
        fixed increments.  Lazily prunes cancelled heap heads."""
        while self._timers and self._timers[0][1] in self._cancelled:
            _, seq, _ = heapq.heappop(self._timers)
            self._cancelled.discard(seq)
        return self._timers[0][0] if self._timers else None

    def timers_pending(self) -> int:
        return sum(1 for (_, seq, _) in self._timers
                   if seq not in self._cancelled)

    def advance(self, dt: float) -> None:
        """Move simulated time forward, firing due timers in deterministic
        ``(fire_at, seq)`` order.  ``now`` tracks each timer as it fires, so
        a callback observing ``now`` sees its own fire time."""
        target = self.now + dt
        while self._timers and self._timers[0][0] <= target:
            fire_at, seq, callback = heapq.heappop(self._timers)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            self.now = max(self.now, fire_at)
            self.timers_fired += 1
            callback()
        self.now = target

    def run_until(self, t: float) -> None:
        """Advance to absolute simulated time ``t`` (no-op if in the past)."""
        if t > self.now:
            self.advance(t - self.now)
