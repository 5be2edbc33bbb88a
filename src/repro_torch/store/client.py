"""KVClient — the client session layer over ``KVCluster`` (paper §4.1).

The paper's client workflow is GET → (values, opaque context) → PUT with
that context.  ``KVClient`` packages the session state that workflow needs
— the client id, the monotone per-session counter (used by the §3
per-client version-vector baselines; DVV ignores it), and session defaults
(proxy node, quorums) — and adds the batched multi-key operations the
single-key API cannot express efficiently:

* ``get_many(keys)``     — one proxy round over many keys; packed quorums
  run as grouped one-sweep quorum merges (``quorum_merge_many``: one
  union-universe remap per quorum set, one stacked ``sync_mask`` sweep,
  one grouped §5.4 ceiling reduce), zero object-clock decodes.  With
  ``repair`` (per call, or ``read_repair=True`` as a session default)
  stale quorum members are healed by one consolidated read-repair push
  each — Dynamo-style convergence on the read path.
* ``put_many({k: (v, ctx)})`` — writes grouped by coordinator; each group
  executes as ONE vectorized store update (``PackedVersionStore.
  update_keys``: one grouped encode → one ``sync_mask`` sweep → one
  scatter) and ONE replication payload per destination replica, instead of
  K independent ``sync_key`` walks and K·(R−1) messages.

Contexts are opaque ``CausalContext`` tokens; ``KVClient`` never inspects
them, it only carries them — exactly the contract real Dynamo/Riak clients
have with their vector-clock blobs.  Because sessions shuttle the *same*
token bytes back and forth (GET → carry → PUT), the session memoizes the
``to_bytes``/``from_bytes`` round-trip: both directions are pure, so the
memo is always sound; it is cleared on any put through the session, which
bounds it to one causal round-trip's worth of tokens.

Two submission modes share all of this session state:

* **synchronous** — ``get``/``put``/``get_many``/``put_many`` call the
  cluster planes directly, one plane invocation per call.
* **scheduled** — with an ``OpScheduler`` attached (``scheduler=`` or
  ``attach_scheduler``), ``submit_get``/``submit_put`` enqueue the op and
  return a ``PendingOp`` future; many sessions' ops then ride ONE plane
  invocation per flush phase (store/serving.py), with per-session results
  split back out.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from .cluster import GetResult, KVCluster, PutAck
from .context import CausalContext

_BYTES = (bytes, bytearray, memoryview)


class KVClient:
    """A client session: owns the client counter and session defaults."""

    def __init__(self, cluster: KVCluster, client_id: str = "client", *,
                 via: Optional[str] = None,
                 read_quorum: Optional[int] = None,
                 write_quorum: Optional[int] = None,
                 use_kernel: bool = True,
                 read_repair: bool = False,
                 scheduler: Optional[Any] = None):
        self.cluster = cluster
        self.client_id = client_id
        self.via = via
        self.read_quorum = read_quorum
        self.write_quorum = write_quorum
        self.use_kernel = use_kernel
        self.read_repair = read_repair   # session default for get_many
        self.counter = 0                 # session-monotone update counter
        self.scheduler = scheduler       # OpScheduler for submit_* (or None)
        # token-codec memo (cleared on any put through this session)
        self._enc_cache: Dict[CausalContext, bytes] = {}
        self._dec_cache: Dict[bytes, CausalContext] = {}
        self.codec_hits = 0
        self.codec_misses = 0

    # -- token codec (memoized per causal round-trip) -----------------------

    def encode_context(self, context: CausalContext) -> bytes:
        """``context.to_bytes()`` through the session memo.  Encoding also
        primes the decode direction — the common GET→carry→PUT round-trip
        pays ``to_bytes`` once and ``from_bytes`` never."""
        data = self._enc_cache.get(context)
        if data is not None:
            self.codec_hits += 1
            return data
        self.codec_misses += 1
        data = context.to_bytes()
        self._enc_cache[context] = data
        self._dec_cache[data] = context
        return data

    def decode_context(self, data: Any) -> CausalContext:
        """``CausalContext.from_bytes`` through the session memo (only
        successful decodes are cached; malformed tokens still raise their
        clean ``ValueError`` every time)."""
        data = bytes(data)
        ctx = self._dec_cache.get(data)
        if ctx is not None:
            self.codec_hits += 1
            return ctx
        self.codec_misses += 1
        ctx = CausalContext.from_bytes(data)
        self._dec_cache[data] = ctx
        self._enc_cache[ctx] = data
        return ctx

    def codec_info(self) -> Dict[str, int]:
        return {"hits": self.codec_hits, "misses": self.codec_misses,
                "cached": len(self._dec_cache)}

    def _invalidate_codec(self) -> None:
        """Any put through the session starts a new causal round-trip:
        drop the memo (both directions are pure, so this is purely a
        bound on staleness-free memory, not a correctness need)."""
        self._enc_cache.clear()
        self._dec_cache.clear()

    def _thaw(self, context: Any) -> Any:
        """Route byte-encoded contexts through the decode memo; everything
        else passes through untouched (the cluster coerces)."""
        if isinstance(context, _BYTES):
            return self.decode_context(context)
        return context

    # -- single-key ---------------------------------------------------------

    def get(self, key: str, *, via: Optional[str] = None,
            quorum: Optional[int] = None) -> GetResult:
        return self.cluster.get(key, via=via or self.via,
                                quorum=quorum or self.read_quorum)

    def put(self, key: str, value: Any, context: Any = None, *,
            via: Optional[str] = None, quorum: Optional[int] = None,
            coordinator: Optional[str] = None) -> PutAck:
        """PUT with an opaque context token (or its ``bytes`` encoding).
        ``context=None`` starts a fresh causal thread (blind write)."""
        self.counter += 1
        context = self._thaw(context)
        self._invalidate_codec()
        return self.cluster.put(
            key, value, context, via=via or self.via,
            client_id=self.client_id, client_counter=self.counter,
            coordinator=coordinator, quorum=quorum or self.write_quorum)

    # -- causal snapshot reads (geo tier) ------------------------------------

    def snapshot_get(self, key: str, *, via: Optional[str] = None
                     ) -> GetResult:
        """Causally consistent, possibly stale read served from the proxy's
        datacenter with zero WAN round trips (geo clusters only).  The
        returned token carries the snapshot's HLC watermark, so a PUT with
        it mints a wall above everything the snapshot saw — session
        causality holds across the two read planes."""
        return self.cluster.snapshot_get(key, via=via or self.via)

    def snapshot_get_many(self, keys: Sequence[str],
                          *, via: Optional[str] = None
                          ) -> Dict[str, GetResult]:
        """Batched causal snapshot read — one Global Stable Frontier for
        the whole batch (see ``KVCluster.snapshot_get_many``)."""
        return self.cluster.snapshot_get_many(keys, via=via or self.via)

    # -- batched ------------------------------------------------------------

    def get_many(self, keys: Sequence[str], *, via: Optional[str] = None,
                 quorum: Optional[int] = None,
                 repair: Optional[bool] = None) -> Dict[str, GetResult]:
        """Batched GET over the one-sweep read plane; ``repair`` overrides
        the session's ``read_repair`` default for this call."""
        return self.cluster.get_many(
            keys, via=via or self.via, quorum=quorum or self.read_quorum,
            repair=self.read_repair if repair is None else repair,
            use_kernel=self.use_kernel)

    def put_many(self, items: Mapping[str, Tuple[Any, Any]], *,
                 via: Optional[str] = None,
                 quorum: Optional[int] = None) -> Dict[str, PutAck]:
        """Batched PUT of ``{key: (value, context)}`` — distinct keys,
        coordinator-grouped vectorized execution (see module docstring)."""
        self.counter += len(items)
        items = {k: (v, self._thaw(c)) for k, (v, c) in items.items()}
        self._invalidate_codec()
        return self.cluster.put_many(
            items, via=via or self.via, client_id=self.client_id,
            client_counter=self.counter,
            quorum=quorum or self.write_quorum,
            use_kernel=self.use_kernel)

    # -- scheduled (coalescing) submission ----------------------------------

    def attach_scheduler(self, scheduler: Any) -> "KVClient":
        """Bind this session to an ``OpScheduler`` (store/serving.py);
        returns ``self`` for chaining."""
        self.scheduler = scheduler
        return self

    def _require_scheduler(self) -> Any:
        if self.scheduler is None:
            raise RuntimeError(
                "session has no OpScheduler attached; pass scheduler= or "
                "call attach_scheduler() before submit_get/submit_put")
        return self.scheduler

    def submit_get(self, keys: Sequence[str], *,
                   quorum: Optional[int] = None,
                   repair: Optional[bool] = None):
        """Enqueue a GET on the session's scheduler → ``PendingOp`` whose
        result is the same ``{key: GetResult}`` dict ``get_many`` returns.
        The op executes at the next flush (size- or timer-triggered)."""
        return self._require_scheduler().submit_get(
            keys, quorum=quorum or self.read_quorum,
            repair=self.read_repair if repair is None else repair,
            client_id=self.client_id, session=self.client_id)

    def submit_snapshot_get(self, keys: Sequence[str]):
        """Enqueue a causal snapshot GET → ``PendingOp`` whose result is
        the same ``{key: GetResult}`` dict ``snapshot_get_many`` returns.
        All snapshot ops admitted into one flush share a single frontier
        resolution and one plane invocation."""
        return self._require_scheduler().submit_snapshot_get(
            keys, client_id=self.client_id, session=self.client_id)

    def submit_put(self, items: Mapping[str, Tuple[Any, Any]], *,
                   quorum: Optional[int] = None):
        """Enqueue a PUT batch → ``PendingOp`` whose result is the same
        ``{key: PutAck}`` dict ``put_many`` returns.  Counts against the
        session counter and invalidates the codec memo at *submission*
        (the put is part of this session's causal thread from that
        moment), exactly like the synchronous path."""
        sched = self._require_scheduler()
        self.counter += len(items)
        items = {k: (v, self._thaw(c)) for k, (v, c) in items.items()}
        self._invalidate_codec()
        return sched.submit_put(
            items, quorum=quorum or self.write_quorum,
            client_id=self.client_id, client_counter=self.counter,
            session=self.client_id)
