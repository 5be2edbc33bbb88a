"""Coalescing serving plane: cross-session batching over the vectorized
planes, plus the closed-loop workload engine that drives it (DESIGN.md §11).

Each *individual* ``get_many``/``put_many`` call is one vectorized sweep,
but every caller still pays the plane's fixed cost (grouping,
union-universe gather, bucket lookup, one device round trip,
per-destination payload assembly) by itself.  ``OpScheduler`` amortizes that cost across
callers, Okapi-style: concurrent sessions *submit* ops; the scheduler
accumulates them on the ``SimNetwork`` timer heap and flushes when either
``max_batch`` ops are queued or ``max_delay`` simulated ticks have passed
since the first — whichever comes first — executing the whole flush as a
handful of plane invocations shared by every session.

**Per-session semantics are preserved exactly** (conformance-tested in
tests/test_serving.py and tests/test_torch_serving.py: byte-identical
results and final replica state vs executing each op alone, both
backends):

* *Phase plan.*  Admitted ops are ordered into alternating GET/PUT phases
  (geo snapshot reads run before them as one shared frontier resolution —
  this flush's puts cannot lift the frontier, so the order is exact).
  A get must run after the last already-planned put on any of its keys; a
  put must run after any planned get or put on its keys.  Puts therefore
  never reorder relative to each other (global wall-clock assignment is
  identical to sequential execution — ``GetResult.value`` resolution
  depends on walls), same-key conflicts sequence into distinct put phases,
  and a session's put→get on one key observes the write even inside one
  flush.  Gets may float past puts on *other* keys: they mint no clocks
  and touch no rows those puts write.
* *One plane call per phase.*  A get phase executes as one
  ``cluster.get_many`` over the deduped union of its keys (per distinct
  (quorum, repair) setting), results split back per op — per-key merges
  are independent, so sharing the sweep is exact.  A put phase merges its
  ops' items into contiguous same-quorum runs, one ``cluster.put_many``
  each; within a phase keys are distinct across ops by construction.  DVV
  ``update`` ignores client identity, so cross-session write batches are
  semantically safe (per-client mechanisms like the §3 VV baseline should
  stay on the synchronous path).
* *Per-op failure isolation.*  The batch planes admit atomically, so the
  scheduler triages each op first via the cluster's non-raising probes:
  an op whose read quorum is short, or with no reachable coordinator,
  fails alone — exactly the set of ops that would raise ``Unavailable``
  sequentially — without poisoning the flush.  A put *predicted* to miss
  its write quorum runs as its own solo call (it still writes durably at
  the coordinator, then reports ``Unavailable`` — the single-call
  contract).  Predictions are exact at ``drop_rate == 0``; with random
  drops, error attribution within a merged run is best-effort.

``ClosedLoopEngine`` is the workload side: millions of *logical* sessions
(compact token records, not objects) issue zipfian-keyed GET → PUT(token)
steps under a fixed concurrency window, with think-time timers, scheduler
flush deadlines, replication pumping and (optionally) ``GossipDriver``
anti-entropy all interleaved on the one deterministic simulated clock.
It records per-op latency in sim ticks (the queueing cost coalescing
pays) against plane invocations and wire bytes per op (what it buys).

``use_kernel`` defaults to ``True`` here, as on the port's cluster: every
plane call sweeps survival on ``cluster.device`` (the CUDA kernels on
"cuda", their plain torch versions on "cpu"); ``use_kernel=False`` asks
for the numpy twins.  The JAX package defaults to ``False``.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np

from .client import KVClient
from .cluster import GetResult, KVCluster, PutAck
from .network import Unavailable


class PendingOp:
    """A submitted-but-not-yet-flushed op: the scheduler's future.

    ``result()`` returns what the synchronous call would have
    (``{key: GetResult}`` / ``{key: PutAck}``) or raises what it would
    have raised; ``latency`` is completion minus submission in simulated
    ticks — the queueing delay coalescing trades for plane sharing.
    """

    __slots__ = ("kind", "keys", "items", "quorum", "repair", "client_id",
                 "client_counter", "session", "submitted_at", "completed_at",
                 "_result", "error", "_callbacks", "_predicted_short")

    def __init__(self, kind: str, keys: Tuple[str, ...], *,
                 items: Optional[Dict[str, Tuple[Any, Any]]] = None,
                 quorum: int = 1, repair: bool = False,
                 client_id: str = "client", client_counter: int = 0,
                 session: Optional[str] = None, submitted_at: float = 0.0):
        self.kind = kind                  # "get" | "put" | "snapshot"
        self.keys = keys
        self.items = items                # puts: {key: (value, context)}
        self.quorum = quorum
        self.repair = repair
        self.client_id = client_id
        self.client_counter = client_counter
        self.session = session if session is not None else client_id
        self.submitted_at = submitted_at
        self.completed_at: Optional[float] = None
        self._result: Any = None
        self.error: Optional[Exception] = None
        self._callbacks: List[Callable[["PendingOp"], None]] = []
        self._predicted_short = False     # put: will miss its write quorum

    @property
    def done(self) -> bool:
        return self.completed_at is not None

    @property
    def latency(self) -> float:
        if self.completed_at is None:
            raise RuntimeError("op not completed yet")
        return self.completed_at - self.submitted_at

    def result(self) -> Any:
        if self.completed_at is None:
            raise RuntimeError("op not completed yet (flush pending)")
        if self.error is not None:
            raise self.error
        return self._result

    def on_done(self, callback: Callable[["PendingOp"], None]) -> None:
        """Run ``callback(op)`` at completion (immediately if already
        done) — how the closed-loop engine chains get → put → think."""
        if self.done:
            callback(self)
        else:
            self._callbacks.append(callback)

    def _complete(self, now: float) -> None:
        self.completed_at = now
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def __repr__(self) -> str:
        state = ("pending" if not self.done
                 else "failed" if self.error is not None else "ok")
        return (f"<PendingOp {self.kind} {list(self.keys)!r} "
                f"session={self.session} {state}>")


class OpScheduler:
    """Accumulates many sessions' ops; flushes them as shared plane calls.

    One scheduler serves one proxy (``via``).  Flush triggers:

    * **size** — the queue reaches ``max_batch`` (flushed synchronously at
      the triggering ``submit``);
    * **timer** — ``max_delay`` simulated ticks after the first op of a
      batch was enqueued (armed on the SimNetwork heap, cancelled when a
      size/manual flush drains first);
    * **manual** — ``flush()``.

    Ops submitted by completion callbacks *during* a flush land in the
    next batch (the flush loop drains again if they re-trip ``max_batch``
    before returning, so the size guarantee holds).
    """

    def __init__(self, cluster: KVCluster, *, via: Optional[str] = None,
                 max_batch: int = 64, max_delay: float = 2.0,
                 read_quorum: Optional[int] = None,
                 write_quorum: Optional[int] = None,
                 read_repair: bool = False, use_kernel: bool = True,
                 pump: bool = False):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_delay <= 0:
            raise ValueError("max_delay must be positive")
        self.cluster = cluster
        self.network = cluster.network
        self.via = via or next(iter(cluster.nodes))
        self.max_batch = max_batch
        self.max_delay = float(max_delay)
        self.read_quorum = read_quorum or cluster.read_quorum
        self.write_quorum = write_quorum or cluster.write_quorum
        self.read_repair = read_repair
        self.use_kernel = use_kernel
        # pump=True drains replication due by flush time before executing
        # (a server-side scheduler is co-located with the delivery loop);
        # without it, reads batched right behind hot-key writes see stale
        # quorum members and read-repair re-ships what replication already
        # has in flight.  Conformance tests leave it off so coalesced and
        # sequential schedules share the exact delivery points.
        self.pump = pump
        self._queue: List[PendingOp] = []
        self._timer: Optional[int] = None
        self._in_flush = False
        # accounting (the serving benchmark's meters)
        self.ops_submitted = 0
        self.ops_ok = 0
        self.ops_failed = 0
        self.flushes = 0
        self.flush_triggers: Counter = Counter()
        self.phases_run = 0
        self.get_calls = 0        # cluster.get_many invocations issued
        self.put_calls = 0        # cluster.put_many invocations issued
        self.snapshot_calls = 0   # cluster.snapshot_get_many invocations
        self.largest_flush = 0

    # -- submission ---------------------------------------------------------

    def submit_get(self, keys: Sequence[str], *,
                   quorum: Optional[int] = None,
                   repair: Optional[bool] = None,
                   client_id: str = "client",
                   session: Optional[str] = None) -> PendingOp:
        op = PendingOp(
            "get", tuple(keys),
            quorum=quorum or self.read_quorum,
            repair=self.read_repair if repair is None else repair,
            client_id=client_id, session=session,
            submitted_at=self.network.now)
        self._enqueue(op)
        return op

    def submit_put(self, items: Mapping[str, Tuple[Any, Any]], *,
                   quorum: Optional[int] = None, client_id: str = "client",
                   client_counter: int = 0,
                   session: Optional[str] = None) -> PendingOp:
        op = PendingOp(
            "put", tuple(items), items=dict(items),
            quorum=quorum or self.write_quorum,
            client_id=client_id, client_counter=client_counter,
            session=session, submitted_at=self.network.now)
        self._enqueue(op)
        return op

    def submit_snapshot_get(self, keys: Sequence[str], *,
                            client_id: str = "client",
                            session: Optional[str] = None) -> PendingOp:
        """Enqueue a causal snapshot GET (geo clusters only).  All snapshot
        ops admitted into one flush execute as ONE
        ``cluster.snapshot_get_many`` — a single frontier resolution shared
        across sessions."""
        op = PendingOp(
            "snapshot", tuple(keys),
            client_id=client_id, session=session,
            submitted_at=self.network.now)
        self._enqueue(op)
        return op

    def session(self, client_id: str, **kw: Any) -> KVClient:
        """A ``KVClient`` bound to this scheduler (and its proxy)."""
        kw.setdefault("via", self.via)
        kw.setdefault("use_kernel", self.use_kernel)
        return KVClient(self.cluster, client_id, scheduler=self, **kw)

    def _enqueue(self, op: PendingOp) -> None:
        self._queue.append(op)
        self.ops_submitted += 1
        if len(self._queue) >= self.max_batch and not self._in_flush:
            self.flush(trigger="size")
        elif self._timer is None and self._queue:
            self._arm()

    def _arm(self) -> None:
        self._timer = self.network.schedule(self.max_delay, self._on_timer)

    def _on_timer(self) -> None:
        self._timer = None
        self.flush(trigger="timer")

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- flushing -----------------------------------------------------------

    def flush(self, trigger: str = "manual") -> int:
        """Drain the queue through shared plane calls; returns the number
        of ops completed.  Reentrant-safe: a flush triggered from inside a
        completion callback is deferred to the outer drain loop."""
        if self._in_flush:
            return 0
        completed = 0
        self._in_flush = True
        try:
            while self._queue:
                ops, self._queue = self._queue, []
                if self._timer is not None:
                    self.network.cancel(self._timer)
                    self._timer = None
                self._run_flush(ops, trigger)
                completed += len(ops)
                if len(self._queue) < self.max_batch:
                    break               # stragglers wait for their timer
                trigger = "size"
        finally:
            self._in_flush = False
        return completed

    def _run_flush(self, ops: List[PendingOp], trigger: str) -> None:
        self.flushes += 1
        self.flush_triggers[trigger] += 1
        self.largest_flush = max(self.largest_flush, len(ops))
        if self.pump:
            self.cluster.deliver_replication(until=self.network.now)
        proxy = self.via
        admitted = self._admit(ops, proxy)
        # Snapshot ops run as their own phase FIRST: they read at the
        # Global Stable Frontier, and this flush's puts cannot lift it —
        # their replication messages / WAN backlog entries are obligations
        # the frontier folds — so snapshot results are order-insensitive
        # within the flush, and running them first keeps the plan's
        # get/put interleave untouched.
        snaps = [op for op in admitted if op.kind == "snapshot"]
        if snaps:
            self.phases_run += 1
            self._run_snapshot_phase(snaps, proxy)
            admitted = [op for op in admitted if op.kind != "snapshot"]
        for kind, phase_ops in self._plan(admitted):
            self.phases_run += 1
            if kind == "get":
                self._run_get_phase(phase_ops, proxy)
            else:
                self._run_put_phase(phase_ops, proxy)
        now = self.network.now
        for op in ops:                   # completion in submission order
            if op.error is None:
                self.ops_ok += 1
            else:
                self.ops_failed += 1
            op._complete(now)

    def _admit(self, ops: List[PendingOp], proxy: str) -> List[PendingOp]:
        """Per-op triage via the cluster's non-raising probes; failed ops
        get exactly the error their solo call would have raised.  Probe
        results are memoized per key for the flush (topology cannot change
        mid-flush — flushes run inside one timer callback)."""
        if proxy in self.network.down:
            err = Unavailable(f"proxy {proxy} is down")
            for op in ops:
                op.error = err
            return []
        read_ok: Dict[Tuple[str, int], bool] = {}
        write_probe: Dict[str, Tuple[Optional[str], int]] = {}
        snap_reason: Dict[str, Optional[str]] = {}
        admitted: List[PendingOp] = []
        for op in ops:
            if op.kind == "snapshot":
                blocked = None
                for k in op.keys:
                    if k not in snap_reason:
                        snap_reason[k] = self.cluster.probe_snapshot(
                            [k], via=proxy)
                    if snap_reason[k] is not None:
                        blocked = snap_reason[k]
                        break
                if blocked is not None:
                    op.error = Unavailable(
                        f"snapshot unavailable via {proxy}: {blocked}")
                    continue
            elif op.kind == "get":
                short = []
                for k in op.keys:
                    ok = read_ok.get((k, op.quorum))
                    if ok is None:
                        ok = read_ok[(k, op.quorum)] = self.cluster.probe_read(
                            k, via=proxy, quorum=op.quorum)
                    if not ok:
                        short.append(k)
                if short:
                    op.error = Unavailable(
                        f"read quorum {op.quorum} unreachable for "
                        f"{len(short)}/{len(op.keys)} keys via {proxy} "
                        f"(e.g. {short[:3]})")
                    continue
            else:
                dead = []
                predicted_short = False
                for k in op.keys:
                    probe = write_probe.get(k)
                    if probe is None:
                        probe = write_probe[k] = self.cluster.probe_write(
                            k, via=proxy)
                    coord, acks = probe
                    if coord is None:
                        dead.append(k)
                    elif acks < op.quorum:
                        predicted_short = True
                if dead:
                    op.error = Unavailable(
                        f"no reachable coordinator for {dead[0]!r}")
                    continue
                op._predicted_short = predicted_short
            admitted.append(op)
        return admitted

    @staticmethod
    def _plan(ops: List[PendingOp]
              ) -> List[Tuple[str, List[PendingOp]]]:
        """Order-preserving phase plan (see module docstring).  Invariants:
        puts keep global submission order; a get lands after the last put
        phase touching its keys; a put lands after every get/put phase
        touching its keys; within a put phase, keys are distinct across
        ops (an overlapping put is barred from joining that phase by its
        own key's ``last_put`` entry)."""
        phases: List[Tuple[str, List[PendingOp]]] = []
        last_put: Dict[str, int] = {}    # key -> last put phase index
        last_get: Dict[str, int] = {}    # key -> last get phase index
        last_put_ix = -1                 # most recent put phase overall
        for op in ops:
            if op.kind == "get":
                barrier = 0
                for k in op.keys:
                    barrier = max(barrier, last_put.get(k, -1) + 1)
                target = -1
                for i in range(barrier, len(phases)):
                    if phases[i][0] == "get":
                        target = i
                        break
                if target < 0:
                    phases.append(("get", []))
                    target = len(phases) - 1
                phases[target][1].append(op)
                for k in op.keys:
                    last_get[k] = max(last_get.get(k, -1), target)
            else:
                barrier = 0
                for k in op.keys:
                    barrier = max(barrier, last_put.get(k, -1) + 1,
                                  last_get.get(k, -1) + 1)
                # join the most recent put phase when the barrier allows —
                # later puts never land in an *earlier* phase than this
                # one, so global put submission order (and with it the
                # wall-clock assignment) is preserved; an interleaved get
                # phase after it is skipped, not a wall for other keys
                if last_put_ix >= barrier:
                    target = last_put_ix
                else:
                    phases.append(("put", []))
                    target = len(phases) - 1
                    last_put_ix = target
                phases[target][1].append(op)
                for k in op.keys:
                    last_put[k] = target
        return phases

    def _run_get_phase(self, ops: List[PendingOp], proxy: str) -> None:
        groups: Dict[Tuple[int, bool], List[PendingOp]] = {}
        for op in ops:
            groups.setdefault((op.quorum, op.repair), []).append(op)
        for (quorum, repair), grp in groups.items():
            union: List[str] = []
            seen = set()
            for op in grp:
                for k in op.keys:
                    if k not in seen:
                        seen.add(k)
                        union.append(k)
            self.get_calls += 1
            try:
                results = self.cluster.get_many(
                    union, via=proxy, quorum=quorum, repair=repair,
                    use_kernel=self.use_kernel)
            except Unavailable as e:     # admission raced only if topology
                for op in grp:           # shifted mid-flush (defensive)
                    op.error = e
                continue
            for op in grp:
                op._result = {k: results[k] for k in op.keys}

    def _run_snapshot_phase(self, ops: List[PendingOp], proxy: str) -> None:
        union: List[str] = []
        seen = set()
        for op in ops:
            for k in op.keys:
                if k not in seen:
                    seen.add(k)
                    union.append(k)
        self.snapshot_calls += 1
        try:
            results = self.cluster.snapshot_get_many(union, via=proxy)
        except (Unavailable, RuntimeError) as e:  # defensive: admission
            for op in ops:                        # already probed these
                op.error = e if isinstance(e, Unavailable) \
                    else Unavailable(str(e))
            return
        for op in ops:
            op._result = {k: results[k] for k in op.keys}

    def _run_put_phase(self, ops: List[PendingOp], proxy: str) -> None:
        # contiguous same-quorum runs; predicted-short ops run solo so
        # their Unavailable (write applied, quorum missed) stays theirs
        runs: List[List[PendingOp]] = []
        for op in ops:
            if runs and not op._predicted_short \
                    and not runs[-1][0]._predicted_short \
                    and runs[-1][0].quorum == op.quorum:
                runs[-1].append(op)
            else:
                runs.append([op])
        for run in runs:
            items: Dict[str, Tuple[Any, Any]] = {}
            for op in run:
                items.update(op.items)
            if len(run) == 1:            # solo: keep the session identity
                cid, cc = run[0].client_id, run[0].client_counter
            else:                        # merged: DVV ignores client ids
                cid, cc = "coalesced", 0
            self.put_calls += 1
            try:
                acks = self.cluster.put_many(
                    items, via=proxy, client_id=cid, client_counter=cc,
                    quorum=run[0].quorum, use_kernel=self.use_kernel)
            except Unavailable as e:
                for op in run:
                    op.error = e
            else:
                for op in run:
                    op._result = {k: self._normalize_ack(acks[k], k)
                                  for k in op.keys}

    def _normalize_ack(self, ack: PutAck, key: str) -> PutAck:
        """Re-sort ``replicated_to`` into the solo-call order (coordinator
        first, then the key's replica order) — a merged ``put_many``
        discovers destinations in whole-group key order, which would leak
        batch composition into per-op results."""
        members = set(ack.replicated_to)
        order = (ack.coordinator,) + tuple(
            r for r in self.cluster.replicas_for(key)
            if r != ack.coordinator and r in members)
        if order == ack.replicated_to:
            return ack
        return PutAck(clock=ack.clock, coordinator=ack.coordinator,
                      replicated_to=order)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "ops_submitted": self.ops_submitted,
            "ops_ok": self.ops_ok,
            "ops_failed": self.ops_failed,
            "pending": len(self._queue),
            "flushes": self.flushes,
            "flush_triggers": dict(self.flush_triggers),
            "phases": self.phases_run,
            "get_calls": self.get_calls,
            "put_calls": self.put_calls,
            "snapshot_calls": self.snapshot_calls,
            "plane_calls": self.get_calls + self.put_calls
            + self.snapshot_calls,
            "largest_flush": self.largest_flush,
        }

    def __repr__(self) -> str:
        return (f"<OpScheduler via={self.via} pending={len(self._queue)} "
                f"flushes={self.flushes} "
                f"plane_calls={self.get_calls + self.put_calls}>")


class ClosedLoopEngine:
    """Zipfian closed-loop workload on the shared simulated clock.

    ``sessions`` logical sessions (token records keyed by session id — a
    million sessions is a dict, not a million client objects) take turns
    through a fixed ``concurrency`` window.  One *step* is the paper's
    client workflow: GET(key) → carry the token as wire bytes → PUT(key,
    value, token) → think-time timer → hand the slot to the next session.
    Keys are drawn zipfian (hot-key contention is the point: same-key
    conflicts must sequence, read-repair must fire); sessions uniformly.

    ``mode="coalesced"`` drives an ``OpScheduler``; ``mode="direct"`` is
    the per-session baseline — every op its own synchronous plane call,
    zero queueing latency.  Same seed ⇒ same key/session/think draws, so
    the two modes run the same workload.
    """

    def __init__(self, cluster: KVCluster, *, sessions: int = 1_000_000,
                 keys: int = 10_000, zipf_s: float = 1.1,
                 concurrency: int = 256, think_time: float = 8.0,
                 rmw_time: float = 1.0,
                 mode: str = "coalesced", via: Optional[str] = None,
                 seed: int = 0, read_repair: bool = True,
                 use_kernel: bool = True,
                 scheduler: Optional[OpScheduler] = None,
                 max_batch: int = 64, max_delay: float = 2.0,
                 pump_period: float = 5.0):
        if mode not in ("coalesced", "direct"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cluster = cluster
        self.network = cluster.network
        self.sessions = sessions
        self.n_keys = keys
        self.zipf_s = zipf_s
        self.concurrency = concurrency
        self.think_time = float(think_time)
        # read-modify-write gap: a client reads, computes, then writes.
        # Both modes pay it identically — without it the direct baseline's
        # get→put is atomic (zero sibling pressure on hot keys), which
        # would overstate coalescing's byte cost rather than its real one.
        self.rmw_time = float(rmw_time)
        self.mode = mode
        self.via = via or next(iter(cluster.nodes))
        self.pump_period = pump_period
        import random
        self.rng = random.Random(seed)
        # zipf CDF over key ranks; one searchsorted per draw
        ranks = np.arange(1, keys + 1, dtype=np.float64)
        weights = 1.0 / np.power(ranks, zipf_s)
        self._cdf = np.cumsum(weights / weights.sum())
        self._keys = [f"k{i}" for i in range(keys)]
        self.scheduler: Optional[OpScheduler] = None
        if mode == "coalesced":
            self.scheduler = scheduler or OpScheduler(
                cluster, via=self.via, max_batch=max_batch,
                max_delay=max_delay, use_kernel=use_kernel, pump=True)
        self.client = KVClient(cluster, "engine", via=self.via,
                               read_repair=read_repair,
                               use_kernel=use_kernel,
                               scheduler=self.scheduler)
        self._tokens: Dict[int, bytes] = {}   # session id -> wire token
        self.steps_started = 0
        self.steps_done = 0
        self.ops_done = 0
        self.ops_failed = 0
        self._latencies: List[float] = []
        self._target_steps = 0
        self._pump_timer: Optional[int] = None

    # -- workload mechanics -------------------------------------------------

    def _pick_key(self) -> str:
        ix = int(np.searchsorted(self._cdf, self.rng.random()))
        return self._keys[min(ix, self.n_keys - 1)]

    def _op_finished(self, latency: float, ok: bool) -> None:
        self.ops_done += 1
        self._latencies.append(latency)
        if not ok:
            self.ops_failed += 1

    def _start_step(self) -> None:
        if self.steps_started >= self._target_steps:
            return                       # slot retires
        self.steps_started += 1
        sid = self.rng.randrange(self.sessions)
        key = self._pick_key()
        if self.mode == "coalesced":
            op = self.client.submit_get([key])
            op.on_done(lambda op, sid=sid, key=key:
                       self._after_get(op, sid, key))
        else:
            try:
                res: Any = self.client.get_many([key])[key]
            except Unavailable:
                res = None
            self._op_finished(0.0, res is not None)
            self._do_put(res, sid, key)

    def _after_get(self, op: PendingOp, sid: int, key: str) -> None:
        self._op_finished(op.latency, op.error is None)
        res = None if op.error is not None else op.result()[key]
        self._do_put(res, sid, key)

    def _do_put(self, res: Optional[GetResult], sid: int, key: str) -> None:
        if res is None:                  # get failed: retry after thinking
            self._finish_step(sid)
            return
        # carry the token as wire bytes — the codec memo's hot loop
        token = self.client.encode_context(res.context)
        self._tokens[sid] = token
        value = f"s{sid}.{self.steps_started}"
        if self.rmw_time:
            delay = self.rmw_time * (0.5 + self.rng.random())
            self.network.schedule(
                delay, lambda: self._issue_put(sid, key, value, token))
        else:
            self._issue_put(sid, key, value, token)

    def _issue_put(self, sid: int, key: str, value: str,
                   token: bytes) -> None:
        if self.mode == "coalesced":
            op = self.client.submit_put({key: (value, token)})
            op.on_done(lambda op, sid=sid: self._after_put(op, sid))
        else:
            try:
                self.client.put_many({key: (value, token)})
                ok = True
            except Unavailable:
                ok = False
            self._op_finished(0.0, ok)
            self._finish_step(sid)

    def _after_put(self, op: PendingOp, sid: int) -> None:
        self._op_finished(op.latency, op.error is None)
        self._finish_step(sid)

    def _finish_step(self, sid: int) -> None:
        self.steps_done += 1
        think = self.think_time * (0.5 + self.rng.random())
        self.network.schedule(think, self._start_step)

    def _pump(self) -> None:
        self.cluster.deliver_replication(until=self.network.now)
        self._pump_timer = self.network.schedule(self.pump_period,
                                                 self._pump)

    # -- driving ------------------------------------------------------------

    def run(self, steps: int, *, max_sim_time: Optional[float] = None
            ) -> Dict[str, Any]:
        """Run ``steps`` closed-loop steps (2 ops each); returns the
        metrics summary.  Event-driven: the loop hops straight to the next
        timer deadline (think, flush or pump) instead of polling."""
        self._target_steps = self.steps_started + steps
        sim0 = self.network.now
        wall0 = time.perf_counter()
        base_planes = self.cluster.plane_invocations
        base_bytes = self.network.bytes_sent
        ops0, fail0 = self.ops_done, self.ops_failed
        lat_from = len(self._latencies)
        if self._pump_timer is None and self.pump_period:
            self._pump_timer = self.network.schedule(self.pump_period,
                                                     self._pump)
        for _ in range(self.concurrency):
            self.network.schedule(self.rng.random() * self.think_time,
                                  self._start_step)
        horizon = None if max_sim_time is None else sim0 + max_sim_time
        while self.steps_done < self._target_steps:
            due = self.network.next_timer_due()
            if due is None or (horizon is not None and due > horizon):
                break
            self.network.advance(max(due - self.network.now, 0.0))
        if self.scheduler is not None:   # complete any stragglers
            self.scheduler.flush()
        self.cluster.deliver_replication(until=self.network.now)
        lat = sorted(self._latencies[lat_from:])
        ops = self.ops_done - ops0

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * (len(lat) - 1) + 0.5))]

        sim_ticks = self.network.now - sim0
        wall_s = time.perf_counter() - wall0
        planes = self.cluster.plane_invocations - base_planes
        nbytes = self.network.bytes_sent - base_bytes
        out: Dict[str, Any] = {
            "mode": self.mode,
            "sessions": self.sessions,
            "active_sessions": len(self._tokens),
            "keys": self.n_keys,
            "zipf_s": self.zipf_s,
            "concurrency": self.concurrency,
            "steps": self.steps_done,
            "ops": ops,
            "ops_failed": self.ops_failed - fail0,
            "sim_ticks": round(sim_ticks, 2),
            "wall_s": round(wall_s, 4),
            "ops_per_sec_wall": round(ops / wall_s, 1) if wall_s else 0.0,
            "ops_per_sim_tick": round(ops / sim_ticks, 3) if sim_ticks
            else 0.0,
            "p50_latency_ticks": round(pct(0.50), 3),
            "p99_latency_ticks": round(pct(0.99), 3),
            "plane_invocations": planes,
            "plane_per_1k_ops": round(1000.0 * planes / ops, 2) if ops
            else 0.0,
            "bytes_per_op": round(nbytes / ops, 1) if ops else 0.0,
            "codec": self.client.codec_info(),
        }
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.stats()
        return out


__all__ = ["PendingOp", "OpScheduler", "ClosedLoopEngine"]
