"""Consistent-hash ring with virtual nodes + fixed key-space shards.

Placement used to be an md5 full-sort over every node *per key*, memoised
in an unbounded per-key dict (``KVCluster._ring_cache``) that grew with the
key universe and was invalidated wholesale on every membership change.
This module replaces it with the classic two-level scheme:

* **Shards** — the key space is cut into a fixed power-of-two number of
  shards by the top bits of a stable 64-bit key hash (blake2b-8, the same
  hash family the digest trees use; top bits so shard choice stays
  independent of the digest-bucket low bits).  A shard is the unit of
  placement, of per-shard packed stores, of gossip planes and of
  rebalance transfer.
* **Ring** — nodes project ``vnodes`` virtual tokens each onto the 64-bit
  hash circle (``blake2b-8("node#v")``).  A shard's replica set is found
  by one ``bisect`` over the sorted token array from the shard's range
  start, walking clockwise until ``replication`` *distinct* nodes are
  collected — O(log V) per lookup, V = nodes x vnodes.

The cluster keeps one O(shards) placement table rebuilt on membership
change (shards x O(log V)); per-key placement is then one hash + one
index.  Memory is bounded by the shard count, never by the key universe,
and a join/leave moves only the shards whose ring walk actually changed —
~1/N of them in expectation, the consistent-hashing guarantee.
"""
from __future__ import annotations

import hashlib
from bisect import bisect_right
from typing import Dict, Iterable, List, Sequence, Tuple

#: Placement granularity when sharded stores are off (``shards=1``): keys
#: still place through the ring, at this many fixed hash-range slices, so
#: the placement table stays O(1)-bounded instead of O(keys).
DEFAULT_PLACEMENT_SLICES = 128

#: Virtual tokens per node.  More vnodes = smoother load split and finer
#: rebalance granularity, at O(log V) lookup cost that grows only in the log.
DEFAULT_VNODES = 64

_HASH_BITS = 64


def key_hash64(s: str) -> int:
    """Stable (process-independent) 64-bit hash — blake2b-8, the single
    hash every placement decision derives from."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


def _check_shards(shards: int) -> int:
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards must be a power of two >= 1, got {shards}")
    return _HASH_BITS - (shards.bit_length() - 1)


def shard_of_hash(h: int, shards: int) -> int:
    """Shard of a 64-bit key hash: the top log2(shards) bits."""
    return h >> _check_shards(shards)


def shard_of_key(key: str, shards: int) -> int:
    if shards == 1:
        return 0
    return key_hash64(key) >> _check_shards(shards)


def shard_point(shard: int, shards: int) -> int:
    """The ring point a shard is placed at: the start of its hash range.
    Every key hashing into the shard shares this placement, which is what
    makes ownership (and therefore rebalance) exact at shard granularity."""
    return shard << _check_shards(shards)


class HashRing:
    """Sorted-token consistent-hash ring with virtual nodes.

    Deterministic: tokens are pure functions of node ids, ties (64-bit
    collisions) break on the node id, and membership is kept as a sorted
    structure — two rings built from the same node set are identical
    whatever the insertion order was.
    """

    def __init__(self, nodes: Iterable[str] = (), *,
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._members: Dict[str, None] = {}
        self._tokens: List[int] = []
        self._owners: List[str] = []
        for n in nodes:
            self._members[n] = None
        self._rebuild()

    # -- membership --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, node: str) -> bool:
        return node in self._members

    @property
    def nodes(self) -> Tuple[str, ...]:
        return tuple(self._members)

    @property
    def n_tokens(self) -> int:
        return len(self._tokens)

    def add(self, node: str) -> None:
        if node in self._members:
            raise ValueError(f"node {node!r} already on ring")
        self._members[node] = None
        self._rebuild()

    def remove(self, node: str) -> None:
        if node not in self._members:
            raise KeyError(f"node {node!r} not on ring")
        del self._members[node]
        self._rebuild()

    def _rebuild(self) -> None:
        pairs = sorted(
            (key_hash64(f"{n}#vn{v}"), n)
            for n in sorted(self._members) for v in range(self.vnodes))
        self._tokens = [t for t, _ in pairs]
        self._owners = [n for _, n in pairs]

    # -- lookup ------------------------------------------------------------

    def replicas_for_hash(self, h: int, n: int) -> Tuple[str, ...]:
        """The first ``n`` distinct nodes clockwise from ``h``: one bisect
        (O(log V)) plus a short walk.  ``n`` past the member count returns
        every member in walk order."""
        V = len(self._tokens)
        if V == 0 or n < 1:
            return ()
        want = min(n, len(self._members))
        start = bisect_right(self._tokens, h) % V
        out: List[str] = []
        seen = set()
        for i in range(V):
            owner = self._owners[(start + i) % V]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) == want:
                    break
        return tuple(out)

    def replicas_for_key(self, key: str, n: int) -> Tuple[str, ...]:
        """Direct per-key lookup (no table): hash + bisect, O(log V)."""
        return self.replicas_for_hash(key_hash64(key), n)

    def placement_table(self, shards: int, n: int
                        ) -> List[Tuple[str, ...]]:
        """Replica sets for every shard — the bounded O(shards) table the
        cluster serves per-key placement from."""
        return [self.replicas_for_hash(shard_point(s, shards), n)
                for s in range(shards)]

    def __repr__(self) -> str:
        return (f"<HashRing nodes={len(self._members)} "
                f"vnodes={self.vnodes} tokens={len(self._tokens)}>")


def owned_shards(table: Sequence[Tuple[str, ...]], node: str
                 ) -> frozenset:
    """Shards whose replica set includes ``node`` under ``table``."""
    return frozenset(s for s, reps in enumerate(table) if node in reps)


def moved_shards(before: Sequence[Tuple[str, ...]],
                 after: Sequence[Tuple[str, ...]]) -> List[int]:
    """Shards whose replica set changed between two placement tables —
    the exact rebalance set on a membership change."""
    return [s for s, (a, b) in enumerate(zip(before, after)) if a != b]


__all__ = [
    "DEFAULT_PLACEMENT_SLICES", "DEFAULT_VNODES", "HashRing",
    "key_hash64", "moved_shards", "owned_shards",
    "shard_of_hash", "shard_of_key", "shard_point",
]
