"""A replica node: per-key version sets + the paper's node-local operations.

Two storage backends implement the same node-local surface:

* ``PackedBackend`` — the default for the DVV mechanism.  Clocks live as
  packed int32 arrays (``store.packed.PackedVersionStore``); object ``DVV``s
  appear only at the client API edge (GET contexts, PUT acks) and in
  control-plane replication messages.  Anti-entropy payloads are
  ``PackedPayload`` arrays end to end.
* ``ObjectBackend`` — Python clock objects in a dict, used by every other
  mechanism (version vectors, LWW, the causal-history oracle) and — forced
  via ``packed=False`` — as the conformance reference the packed store is
  tested observationally equal to.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Sequence, \
    Tuple, Union

from ..core import batched as B
from ..core.kernel import Mechanism
from .context import CausalContext
from .packed import DIGEST_BUCKETS, PackedPayload, PackedVersionStore, \
    concat_payloads, split_payload
from .sharding import shard_of_key
from .version import Version, clocks_of, sync_versions

Payload = Union[Dict[str, FrozenSet[Version]], PackedPayload]

#: One batched write: (key, context token, value, wall_time).
UpdateBatch = Sequence[Tuple[str, CausalContext, Any, float]]


class ObjectBackend:
    """Per-key frozensets of (clock, value) objects — the generic backend."""

    def __init__(self, mechanism: Mechanism, node_id: str):
        self.mechanism = mechanism
        self.node_id = node_id
        self.store: Dict[str, FrozenSet[Version]] = {}
        # geo tier (DESIGN.md §12): same displacement hook + wall high-water
        # surface as PackedVersionStore, so the snapshot plane's shadow
        # retention is backend-agnostic (packed==object conformance).
        self.max_wall = 0.0
        self.shadow_hook = None
        # durability tier (DESIGN.md §14): ``wal_hook(key, merged)`` fires
        # with the committed post-state whenever a key's set changes — the
        # object-backend mirror of ``PackedVersionStore.wal_hook``.
        self.wal_hook = None

    def versions(self, key: str) -> FrozenSet[Version]:
        return self.store.get(key, frozenset())

    def _store_merged(self, key: str, before: FrozenSet[Version],
                      merged: FrozenSet[Version]) -> None:
        self.store[key] = merged
        if merged:
            top = max(v.wall for v in merged)
            if top > self.max_wall:
                self.max_wall = top
        if self.shadow_hook is not None and before and merged != before:
            self.shadow_hook(key, before)
        if self.wal_hook is not None and merged != before:
            self.wal_hook(key, merged)

    def apply_sync(self, key: str, incoming: FrozenSet[Version]
                   ) -> FrozenSet[Version]:
        before = self.versions(key)
        merged = sync_versions(
            before, incoming,
            total_order=not self.mechanism.tracks_concurrency)
        self._store_merged(key, before, merged)
        return merged

    def replace_key(self, key: str, versions: FrozenSet[Version]) -> None:
        """Overwrite one key's version set with an already-merged result
        (the bulk delta-round write-back) through the same shadow/wall
        bookkeeping as ``apply_sync``."""
        self._store_merged(key, self.versions(key), versions)

    def coordinate_update(self, key: str, value: Any,
                          context: CausalContext, *,
                          client_id: str, client_counter: int,
                          wall_time: float) -> Version:
        u_clock = self.mechanism.update(
            context.to_clock_set(), clocks_of(self.versions(key)),
            self.node_id, client_id, client_counter, wall_time)
        version = Version(u_clock, value, wall=wall_time)
        self.apply_sync(key, frozenset({version}))
        return version

    def antientropy_payload(self, keys: Optional[Iterable[str]] = None
                            ) -> Dict[str, FrozenSet[Version]]:
        if keys is None:
            keys = list(self.store.keys())
        return {k: self.versions(k) for k in keys}

    def receive_antientropy(self, payload: Payload) -> int:
        changed = 0
        for k, versions in _as_object_payload(payload).items():
            before = self.versions(k)
            if self.apply_sync(k, versions) != before:
                changed += 1
        return changed

    def metadata_size(self, key: str) -> int:
        return sum(v.clock.size() for v in self.versions(key))

    def total_keys(self) -> int:
        return len(self.store)


class PackedBackend:
    """Packed int32 clocks as the resident representation (DVV only).

    With ``shards > 1`` the key space is cut by the stable 64-bit key hash
    (``sharding.shard_of_key``) into that many independent
    ``PackedVersionStore``s, each with its own (proportionally narrower)
    digest tree — stores stay cache-sized, and compaction, digest rebuilds
    and delta rounds are per-shard.  Every entry point routes by key
    shard; cross-shard batches are grouped so each shard still runs its
    one vectorized pass.  ``shards == 1`` is byte-identical to the
    unsharded store.
    """

    def __init__(self, mechanism: Mechanism, node_id: str, *,
                 shards: int = 1):
        if mechanism.name != "dvv":
            # The packed backend *implements* the DVV §5.3 update/sync in
            # arrays; running it under another mechanism would silently
            # swap that mechanism's semantics for DVV's.
            raise ValueError(
                f"packed backend implements DVV semantics; mechanism "
                f"{mechanism.name!r} must use the object backend")
        if shards < 1 or shards & (shards - 1):
            raise ValueError(
                f"shards must be a power of two >= 1, got {shards}")
        self.mechanism = mechanism
        self.node_id = node_id
        self.shards = shards
        # Split the digest budget across shards so a sharded node's total
        # leaf count starts where the unsharded one did (each store still
        # widens itself with size).
        buckets = max(DIGEST_BUCKETS // shards, 16)
        self.stores: List[PackedVersionStore] = [
            PackedVersionStore(n_buckets=buckets) for _ in range(shards)]
        for st in self.stores:
            st.intern_replica(node_id)

    @property
    def packed(self) -> PackedVersionStore:
        """The single store of an unsharded backend (shard 0 otherwise) —
        the pre-sharding attribute most introspection reaches for."""
        return self.stores[0]

    def store_for(self, key: str) -> PackedVersionStore:
        return self.stores[shard_of_key(key, self.shards)]

    def versions(self, key: str) -> FrozenSet[Version]:
        return self.store_for(key).versions(key)   # edge decode, one key

    def apply_sync(self, key: str, incoming: FrozenSet[Version]
                   ) -> FrozenSet[Version]:
        """Object versions arrive from control-plane replication messages;
        encode at the boundary, then merge in arrays."""
        self.store_for(key).sync_key_objects(key, incoming)
        return self.versions(key)

    def coordinate_update(self, key: str, value: Any,
                          context: CausalContext, *,
                          client_id: str, client_counter: int,
                          wall_time: float) -> Version:
        # Token-native: the ceiling entries go straight to int32 columns —
        # no clock object is built from the context.
        store = self.store_for(key)
        ctx_vv = store.ceiling_of_entries(context.ceiling_items())
        vv, r_ix, dot_n = store.update_key(
            key, ctx_vv, self.node_id, value, wall=wall_time)
        # Decode only the freshly minted clock for the PutAck (edge decode).
        clock = B.decode(vv[: store.n_replicas], r_ix, dot_n,
                         store.replica_ids)
        return Version(clock, value, wall=wall_time)

    def coordinate_updates(self, batch: UpdateBatch, *,
                           mask_fn=None) -> List[Version]:
        """Batched §5.3 updates over distinct keys: one grouped encode →
        one vectorized update → one scatter (``PackedVersionStore.
        update_keys``) *per shard touched*, instead of K independent
        ``sync_key`` walks.  Results come back in batch order."""
        groups: Dict[int, List[int]] = {}
        for i, (key, _, _, _) in enumerate(batch):
            groups.setdefault(shard_of_key(key, self.shards), []).append(i)
        out: List[Optional[Version]] = [None] * len(batch)
        for s, idxs in groups.items():
            store = self.stores[s]
            items = [(batch[i][0], batch[i][1].ceiling_items(),
                      batch[i][2], batch[i][3]) for i in idxs]
            vv, r_ix, dot_n = store.update_keys(
                items, self.node_id, mask_fn=mask_fn)
            R = store.n_replicas
            for j, i in enumerate(idxs):
                out[i] = Version(
                    B.decode(vv[j, :R], r_ix, int(dot_n[j]),
                             store.replica_ids),
                    batch[i][2], wall=batch[i][3])
        return out                                 # type: ignore[return-value]

    def antientropy_payload(self, keys: Optional[Iterable[str]] = None
                            ) -> PackedPayload:
        if self.shards == 1:
            return self.stores[0].payload(keys)    # arrays out, zero decode
        if keys is None:
            return concat_payloads([st.payload() for st in self.stores])
        by_shard: Dict[int, List[str]] = {}
        for k in keys:
            by_shard.setdefault(shard_of_key(k, self.shards), []).append(k)
        return concat_payloads([self.stores[s].payload(ks)
                                for s, ks in by_shard.items()])

    def receive_antientropy(self, payload: Payload, *,
                            mask_fn=None) -> int:
        if isinstance(payload, PackedPayload):     # arrays in, zero encode
            if self.shards == 1:
                return self.stores[0].apply_payload(payload, mask_fn=mask_fn)
            return sum(
                self.stores[s].apply_payload(part, mask_fn=mask_fn)
                for s, part in split_payload(payload, self.shards).items())
        changed = 0
        for k, versions in payload.items():
            before = self.versions(k)
            if self.apply_sync(k, versions) != before:
                changed += 1
        return changed

    def metadata_size(self, key: str) -> int:
        return self.store_for(key).metadata_size(key)

    def total_keys(self) -> int:
        return sum(len(st.keys) for st in self.stores)

    @property
    def max_wall(self) -> float:
        """Max over the per-shard wall-column high-water marks (each an
        O(1) fold maintained by the stores)."""
        return max(st.max_wall for st in self.stores)

    @property
    def shadow_hook(self):
        return self.stores[0].shadow_hook

    @shadow_hook.setter
    def shadow_hook(self, fn) -> None:
        for st in self.stores:
            st.shadow_hook = fn


def _as_object_payload(payload: Payload) -> Dict[str, FrozenSet[Version]]:
    """Decode a packed payload for an object-backend receiver (mixed-backend
    interop; not a hot path)."""
    if not isinstance(payload, PackedPayload):
        return payload
    out: Dict[str, set] = {k: set() for k in payload.keys}
    R = len(payload.replica_ids)
    for i in range(len(payload)):
        clock = B.decode(payload.vv[i, :R], int(payload.dot_id[i]),
                         int(payload.dot_n[i]), payload.replica_ids)
        out[payload.keys[int(payload.key_ix[i])]].add(
            Version(clock, payload.values[i], wall=float(payload.wall[i])))
    return {k: frozenset(v) for k, v in out.items()}


class ReplicaNode:
    """Facade over a storage backend; the paper's §4.1 node-local steps.

    ``shards`` partitions the key space (``sharding.shard_of_key``) into
    that many per-shard packed stores.  The object backend keeps one dict
    — sharding is a *physical* layout choice and must be observationally
    invisible, which is exactly what the packed==object conformance suite
    checks — but the node still records the logical shard count so
    protocol layers (bootstrap, handoff) can filter by shard on either
    backend.
    """

    def __init__(self, node_id: str, mechanism: Mechanism,
                 packed: Optional[bool] = None, *, shards: int = 1):
        self.node_id = node_id
        self.mechanism = mechanism
        self.shards = shards
        if packed is None:
            packed = mechanism.name == "dvv"
        self.backend = (
            PackedBackend(mechanism, node_id, shards=shards) if packed
            else ObjectBackend(mechanism, node_id))

    @property
    def is_packed(self) -> bool:
        return isinstance(self.backend, PackedBackend)

    # -- shard routing -----------------------------------------------------
    def shard_of(self, key: str) -> int:
        return shard_of_key(key, self.shards)

    def store_for(self, key: str) -> PackedVersionStore:
        """The packed store holding ``key`` (packed backends only)."""
        return self.backend.store_for(key)      # type: ignore[union-attr]

    @property
    def shard_stores(self) -> List[PackedVersionStore]:
        """All per-shard packed stores (packed backends only)."""
        return self.backend.stores              # type: ignore[union-attr]

    def versions(self, key: str) -> FrozenSet[Version]:
        return self.backend.versions(key)

    def clocks(self, key: str) -> FrozenSet[Any]:
        return clocks_of(self.versions(key))

    # -- §4.1 node-local steps ------------------------------------------------
    def apply_sync(self, key: str, incoming: FrozenSet[Version]
                   ) -> FrozenSet[Version]:
        """S_i' = sync(S_i, incoming); store and return it."""
        return self.backend.apply_sync(key, incoming)

    def coordinate_update(self, key: str, value: Any,
                          context: Any = None, *,
                          client_id: str = "?", client_counter: int = 0,
                          wall_time: float = 0.0) -> Version:
        """u = update(S, S_C, C) followed by S_C' = sync(S_C, {u}).

        ``context`` may be a ``CausalContext`` token, its bytes encoding,
        or (deprecated) a raw clock set."""
        return self.backend.coordinate_update(
            key, value, CausalContext.coerce(context), client_id=client_id,
            client_counter=client_counter, wall_time=wall_time)

    def coordinate_updates(self, batch: UpdateBatch, *,
                           client_id: str = "?", client_counter: int = 0,
                           mask_fn=None) -> List[Version]:
        """Batched multi-key coordination.  The packed backend takes the
        one-scatter vectorized path; the object backend (the conformance
        reference, and any non-DVV mechanism) degrades to a loop."""
        if isinstance(self.backend, PackedBackend):
            return self.backend.coordinate_updates(batch, mask_fn=mask_fn)
        return [
            self.backend.coordinate_update(
                key, value, ctx, client_id=client_id,
                client_counter=client_counter, wall_time=wall)
            for (key, ctx, value, wall) in batch]

    # -- anti-entropy ------------------------------------------------------------
    def antientropy_payload(self, keys: Optional[Iterable[str]] = None
                            ) -> Payload:
        return self.backend.antientropy_payload(keys)

    def receive_antientropy(self, payload: Payload, *,
                            mask_fn=None) -> int:
        if isinstance(self.backend, PackedBackend):
            return self.backend.receive_antientropy(payload, mask_fn=mask_fn)
        return self.backend.receive_antientropy(payload)

    # -- introspection -------------------------------------------------------------
    def metadata_size(self, key: str) -> int:
        """Total integers stored in clocks for ``key`` (paper's space metric)."""
        return self.backend.metadata_size(key)

    def total_keys(self) -> int:
        return self.backend.total_keys()

    @property
    def max_wall(self) -> float:
        """High-water mark of the node's wall column (geo frontier input)."""
        return self.backend.max_wall
