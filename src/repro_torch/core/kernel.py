"""The eventual-consistency kernel (paper §4).

Two operations on *sets of clocks* are the whole interface between a
key-value store and its causality mechanism:

* ``sync(S1, S2)``  — merge two divergent clock sets, discarding obsolete
  versions.  Generic over the partial order; implemented once.
* ``update(S, Sr, r)`` — mint the clock for a new PUT from the client context
  ``S``, the coordinator's current set ``Sr`` and its id ``r``.
  Representation-specific; each mechanism plugs its own.

This module also encodes the paper's *formal conditions* on both operations
as executable predicates — the hypothesis property tests drive random store
schedules through them.

``Mechanism`` bundles a clock implementation so the replicated store
(`repro.store`) and the benchmarks can swap mechanisms on identical
schedules and compare outcomes (lost updates, false concurrency, metadata
size) — reproducing the paper's §3 survey experimentally.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, FrozenSet, Generic, Iterable, Set, TypeVar

from . import dvv as _dvv
from . import version_vector as _vv
from .causal_history import CausalHistory, union_all

C = TypeVar("C")  # a clock type with .lt/.leq


def generic_sync(S1: FrozenSet[C], S2: FrozenSet[C]) -> FrozenSet[C]:
    """Paper §4: defined only in terms of the partial order on clocks."""
    keep1 = {x for x in S1 if not any(x.lt(y) for y in S2)}
    keep2 = {x for x in S2 if not any(x.lt(y) for y in S1)}
    return frozenset(keep1 | keep2)


def antichain(S: Iterable[C]) -> FrozenSet[C]:
    """Reduce a clock set to its maximal elements (defensive helper)."""
    S = list(S)
    return frozenset(
        x for i, x in enumerate(S)
        if not any(x.lt(y) for j, y in enumerate(S) if i != j)
    )


# ---------------------------------------------------------------------------
# Formal conditions (paper §4) as predicates, used by property tests.
# ---------------------------------------------------------------------------

def sync_conditions_hold(S1: FrozenSet[C], S2: FrozenSet[C],
                         S: FrozenSet[C]) -> bool:
    """Check the three conditions on S = sync(S1, S2).

    Condition 2 is read over clock *equivalence classes*: DVV
    representations are not canonical — e.g. ``{(a,2,3)}`` and ``{(a,3)}``
    denote the same causal history {a1,a2,a3} (found by hypothesis) — so
    "∀x,y ∈ S. x ≰ y" means no *strict* domination; mutually-≤ pairs are
    the same clock written two ways.  (The store itself never mints
    dotless version clocks, so such pairs cannot arise in protocol
    states — see tests/test_kernel_properties.py.)
    """
    both = S1 | S2
    # 1) every element of S comes from the inputs
    if not all(x in both for x in S):
        return False
    # 2) S is an antichain up to equivalence: no strict domination inside
    for x in S:
        for y in S:
            if x != y and x.leq(y) and not y.leq(x):
                return False
    # 3) everything in the inputs is dominated by something in S
    return all(any(x.leq(y) for y in S) for x in both)


def update_conditions_hold_histories(
    S_hist: FrozenSet[CausalHistory],
    all_replica_hists: FrozenSet[CausalHistory],
    u_hist: CausalHistory,
) -> bool:
    """Check the three §4 conditions on u = update(S, Sr, r), in history space.

    Working in causal-history space makes the join ⊔S simply the union of
    event sets, so the conditions are directly checkable for any mechanism
    that provides ``to_history``.
    """
    # 1) ∀x ∈ S. x ≤ u
    if not all(x.leq(u_hist) for x in S_hist):
        return False
    # 2) ∀x stored anywhere. x ≤ u ⇒ x ≤ ⊔S
    join_S = union_all(S_hist)
    for x in all_replica_hists:
        if x.leq(u_hist) and not x.leq(join_S):
            return False
    # 3) u is not dominated by the join of everything already in the system
    join_all = union_all(all_replica_hists)
    return not u_hist.leq(join_all)


# ---------------------------------------------------------------------------
# Mechanism registry — one entry per §3/§5 approach.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mechanism(Generic[C]):
    """A pluggable causality mechanism for the replicated store.

    ``update(context_set, local_set, replica_id, client_id, client_counter,
    wall_time)`` returns the clock for a new version.  Mechanisms ignore the
    arguments they do not need.
    """

    name: str
    update: Callable[..., C]
    sync: Callable[[FrozenSet[C], FrozenSet[C]], FrozenSet[C]]
    zero_context: FrozenSet[C]
    tracks_concurrency: bool  # False for total orders (LWW / Lamport)


def _dvv_update(S, Sr, r, client, counter, wall_time):
    return _dvv.update(frozenset(S), frozenset(Sr), r)


def _vv_server_update(S, Sr, r, client, counter, wall_time):
    ctx = _vv.merge_all(S)
    return _vv.update_per_server(ctx, frozenset(Sr), r)


def _vv_client_stateful_update(S, Sr, r, client, counter, wall_time):
    ctx = _vv.merge_all(S)
    return _vv.update_per_client_stateful(ctx, client, counter)


def _vv_client_inferred_update(S, Sr, r, client, counter, wall_time):
    ctx = _vv.merge_all(S)
    return _vv.update_per_client_inferred(ctx, frozenset(Sr), client)


def _lamport_update(S, Sr, r, client, counter, wall_time):
    from .lww import lamport_update
    return lamport_update(frozenset(S), frozenset(Sr), r)


def _wallclock_update(S, Sr, r, client, counter, wall_time):
    from .lww import WallClock
    return WallClock(wall_time, client)


def _oracle_update(S, Sr, r, client, counter, wall_time):
    """Explicit causal histories (paper §3/Fig. 1) — the exact reference.

    The new event id ``(r, n)`` uses the same argument as DVV's dot: every
    r-event is minted at r and never evicted below r's local ceiling, so
    ``max_r(Sr) + 1`` is globally fresh.
    """
    ctx = union_all(S)
    n = max((h.max_counter(r) for h in Sr), default=0) + 1
    return ctx.add((r, n))


def _oracle_sync(S1, S2):
    keep1 = {x for x in S1 if not any(x.lt(y) for y in S2)}
    keep2 = {x for x in S2 if not any(x.lt(y) for y in S1)}
    return frozenset(keep1 | keep2)


def _lww_sync(S1, S2):
    """Total-order sync: keep only the single largest clock."""
    allc = list(S1 | S2)
    if not allc:
        return frozenset()
    best = allc[0]
    for c in allc[1:]:
        if best.lt(c):
            best = c
    return frozenset({best})


DVV_MECHANISM = Mechanism(
    name="dvv", update=_dvv_update, sync=_dvv.sync,
    zero_context=frozenset(), tracks_concurrency=True)

VV_SERVER_MECHANISM = Mechanism(
    name="vv_server", update=_vv_server_update, sync=_vv.sync_vv,
    zero_context=frozenset(), tracks_concurrency=True)

VV_CLIENT_MECHANISM = Mechanism(
    name="vv_client", update=_vv_client_stateful_update, sync=_vv.sync_vv,
    zero_context=frozenset(), tracks_concurrency=True)

VV_CLIENT_INFERRED_MECHANISM = Mechanism(
    name="vv_client_inferred", update=_vv_client_inferred_update, sync=_vv.sync_vv,
    zero_context=frozenset(), tracks_concurrency=True)

LAMPORT_MECHANISM = Mechanism(
    name="lamport", update=_lamport_update, sync=_lww_sync,
    zero_context=frozenset(), tracks_concurrency=False)

WALLCLOCK_MECHANISM = Mechanism(
    name="wallclock_lww", update=_wallclock_update, sync=_lww_sync,
    zero_context=frozenset(), tracks_concurrency=False)

ORACLE_MECHANISM = Mechanism(
    name="oracle", update=_oracle_update, sync=_oracle_sync,
    zero_context=frozenset(), tracks_concurrency=True)

ALL_MECHANISMS = {
    m.name: m for m in [
        DVV_MECHANISM, VV_SERVER_MECHANISM, VV_CLIENT_MECHANISM,
        VV_CLIENT_INFERRED_MECHANISM, LAMPORT_MECHANISM, WALLCLOCK_MECHANISM,
        ORACLE_MECHANISM,
    ]
}
