"""DVV-backed coordination services: the membership ledger and the
work-stealing lease ledger, running *through* the replicated store.

Both services are pure clients of the store's get/put surface and exist
because their workloads are exactly the paper's motivating anomalies —

* **Membership** (``MembershipService``): ``node_id -> (status, epoch)``
  stored under one key.  Elastic scale-up/down means *concurrent*
  membership writes through different coordinators — the workload where a
  per-server version vector linearizes concurrent joins (paper §3.2) and
  LWW drops one (paper §3.1).  Under DVV the divergent views surface as
  siblings and merge with a deterministic join (pointwise max epoch,
  status priority), written back with the full context so the merge
  dominates both branches.  This *ledger* complements the §13 liveness
  plane (``store.failure.MembershipController``): the controller decides
  who is reachable, the ledger records who is *administratively* in.

* **Leases** (``WorkStealer``): shards of work leased through the store.
  Two workers claiming the same shard through the same coordinator is the
  paper's Fig. 3 same-server concurrency — VV silently overwrites one
  claim and both workers think they own the shard; DVV surfaces both as
  siblings and ``resolve_lease_siblings`` picks one deterministic winner.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, Optional, Tuple

from .cluster import KVCluster
from .network import Unavailable

MEMBERSHIP_KEY = "cluster/membership"


class NodeStatus(IntEnum):
    # ordered by reconciliation priority at equal epoch: dead > leaving > alive
    ALIVE = 0
    LEAVING = 1
    DEAD = 2


@dataclass(frozen=True)
class MemberView:
    """Immutable membership snapshot."""

    members: Tuple[Tuple[str, Tuple[int, int]], ...] = ()  # (node, (status, epoch))

    @staticmethod
    def from_dict(d: Dict[str, Tuple[int, int]]) -> "MemberView":
        return MemberView(tuple(sorted(d.items())))

    def to_dict(self) -> Dict[str, Tuple[int, int]]:
        return {k: tuple(v) for k, v in self.members}

    def serialize(self) -> str:
        return json.dumps(self.members, sort_keys=True)

    @staticmethod
    def deserialize(s: str) -> "MemberView":
        raw = json.loads(s)
        return MemberView(tuple((n, tuple(v)) for n, v in raw))

    def alive(self) -> Tuple[str, ...]:
        return tuple(n for n, (s, _) in self.members
                     if s == NodeStatus.ALIVE)

    @staticmethod
    def merge(views: "Tuple[MemberView, ...]") -> "MemberView":
        """Deterministic join of divergent sibling views."""
        out: Dict[str, Tuple[int, int]] = {}
        for view in views:
            for node, (status, epoch) in view.members:
                if node not in out:
                    out[node] = (status, epoch)
                else:
                    s0, e0 = out[node]
                    # higher epoch wins; at equal epoch the more terminal
                    # status wins (a node seen dead stays dead until it
                    # rejoins with a higher epoch)
                    if (epoch, status) > (e0, s0):
                        out[node] = (status, epoch)
        return MemberView.from_dict(out)


class MembershipService:
    """Client-side membership operations against the replicated store."""

    def __init__(self, store: KVCluster, self_id: str):
        self.store = store
        self.self_id = self_id

    def _read(self, via: Optional[str] = None):
        try:
            res = self.store.get(MEMBERSHIP_KEY, via=via or self.self_id)
        except (Unavailable, KeyError):
            return MemberView(), frozenset()
        if not res.values:
            return MemberView(), res.context
        views = tuple(MemberView.deserialize(v) for v in res.values)
        return MemberView.merge(views), res.context

    def view(self, via: Optional[str] = None) -> MemberView:
        return self._read(via)[0]

    def _transition(self, node: str, status: NodeStatus,
                    via: Optional[str] = None, bump_epoch: bool = True) -> MemberView:
        view, ctx = self._read(via)
        d = view.to_dict()
        _, epoch = d.get(node, (NodeStatus.ALIVE, -1))
        d[node] = (int(status), epoch + 1 if bump_epoch else epoch)
        new = MemberView.from_dict(d)
        self.store.put(MEMBERSHIP_KEY, new.serialize(), context=ctx,
                       via=via or self.self_id, client_id=self.self_id)
        return new

    def join(self, node: Optional[str] = None, via: Optional[str] = None):
        return self._transition(node or self.self_id, NodeStatus.ALIVE, via)

    def leave(self, node: Optional[str] = None, via: Optional[str] = None):
        return self._transition(node or self.self_id, NodeStatus.LEAVING, via)

    def mark_dead(self, node: str, via: Optional[str] = None):
        return self._transition(node, NodeStatus.DEAD, via)

    def reconcile(self, via: Optional[str] = None) -> MemberView:
        """Merge any sibling views and persist the join (reader-repair)."""
        view, ctx = self._read(via)
        if ctx:
            self.store.put(MEMBERSHIP_KEY, view.serialize(), context=ctx,
                           via=via or self.self_id, client_id=self.self_id)
        return view


# -- work-stealing lease ledger ---------------------------------------------


def _lease_key(shard: str) -> str:
    return f"lease/{shard}"


@dataclass(frozen=True)
class Lease:
    shard: str
    owner: str
    expires: float
    attempt: int

    def serialize(self) -> str:
        return json.dumps({"shard": self.shard, "owner": self.owner,
                           "expires": self.expires, "attempt": self.attempt})

    @staticmethod
    def deserialize(s: str) -> "Lease":
        return Lease(**json.loads(s))


def resolve_lease_siblings(leases: Tuple[Lease, ...]) -> Lease:
    """Deterministic winner among concurrent claims: highest attempt, then
    latest expiry, then lowest owner id (total, schedule-independent)."""
    return sorted(leases,
                  key=lambda l: (-l.attempt, -l.expires, l.owner))[0]


class WorkStealer:
    def __init__(self, store: KVCluster, worker_id: str,
                 lease_duration: float = 10.0):
        self.store = store
        self.worker_id = worker_id
        self.lease_duration = lease_duration

    def _read(self, shard: str, via: Optional[str] = None):
        try:
            res = self.store.get(_lease_key(shard), via=via)
        except Unavailable:
            return None, frozenset()
        if not res.values:
            return None, res.context
        leases = tuple(Lease.deserialize(v) for v in res.values)
        return resolve_lease_siblings(leases), res.context

    def try_claim(self, shard: str, now: float,
                  via: Optional[str] = None) -> bool:
        """Attempt to lease ``shard``.  Returns True iff after the write this
        worker is the resolved owner (the claim may race; we re-read)."""
        current, ctx = self._read(shard, via=via)
        if current is not None and current.owner != self.worker_id \
                and current.expires > now:
            return False  # actively held by someone else
        attempt = (current.attempt + 1) if current else 0
        lease = Lease(shard, self.worker_id, now + self.lease_duration, attempt)
        try:
            self.store.put(_lease_key(shard), lease.serialize(), context=ctx,
                           via=via, client_id=self.worker_id)
        except Unavailable:
            return False
        resolved, _ = self._read(shard, via=via)
        return resolved is not None and resolved.owner == self.worker_id

    def renew(self, shard: str, now: float, via: Optional[str] = None) -> bool:
        current, ctx = self._read(shard, via=via)
        if current is None or current.owner != self.worker_id:
            return False
        lease = Lease(shard, self.worker_id, now + self.lease_duration,
                      current.attempt)
        self.store.put(_lease_key(shard), lease.serialize(), context=ctx,
                       via=via, client_id=self.worker_id)
        return True

    def owner(self, shard: str, via: Optional[str] = None) -> Optional[str]:
        lease, _ = self._read(shard, via=via)
        return lease.owner if lease else None

    def steal_expired(self, shard: str, now: float,
                      via: Optional[str] = None) -> bool:
        """Straggler mitigation: take over a shard whose lease lapsed."""
        current, _ = self._read(shard, via=via)
        if current is None or current.expires > now:
            return False
        return self.try_claim(shard, now, via=via)


__all__ = [
    "MEMBERSHIP_KEY", "NodeStatus", "MemberView", "MembershipService",
    "Lease", "WorkStealer", "resolve_lease_siblings",
]
