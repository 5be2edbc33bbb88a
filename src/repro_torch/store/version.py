"""Versions: (clock, value) pairs — what replica nodes actually store.

``sync`` is lifted from clock sets (paper §4) to version sets: a version is
discarded iff its clock is strictly dominated.  Versions with equal clocks
are the same write (clocks are unique per update event) and are deduped.

Each version also records the coordinator wall-time of its PUT.  The wall
is *metadata*, not causality: it is excluded from equality/hashing (two
replicas holding the same write compare equal whatever bookkeeping they
carry) and never enters a clock comparison.  Its one job is the
deterministic register resolution of ``GetResult.value`` — concurrent
siblings are totally ordered by ``(wall, repr(clock), repr(value))``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, FrozenSet, Tuple


@dataclass(frozen=True)
class Version:
    clock: Any
    value: Any
    wall: float = field(default=0.0, compare=False)

    def __repr__(self) -> str:
        return f"<{self.value!r} @ {self.clock!r}>"


# -- hybrid logical clocks (geo tier) ---------------------------------------
#
# The wall column doubles as a hybrid logical clock (GentleRain+-style):
# one float64 encodes (l, c) as l + c·2^-20, where l is the physical
# component (max physical time seen) and c the logical tiebreak counter.
# Exact in float64 for l < 2^31 and c < 2^20: the integer part needs 31
# bits, the fraction 20, both well inside the 52-bit mantissa.  Comparing
# encoded walls IS the HLC order (l first, c second), so the packed
# store's float64 wall column and every existing resolution path order
# HLC-minted versions correctly with zero schema change.

HLC_STEP = 2.0 ** -20           # one logical tick in encoded units
HLC_EPS = 2.0 ** -21            # < any tick: strict-inequality epsilon


def hlc_encode(l: int, c: int) -> float:
    return float(l) + c * HLC_STEP


def hlc_decode(wall: float) -> Tuple[int, int]:
    l = int(wall)
    return l, int(round((wall - l) / HLC_STEP))


class HybridClock:
    """Per-node HLC state: ``mint`` stamps a local event, ``observe``
    merges a remote wall (message receive), ``observe_physical`` folds in
    a bare physical reading (heartbeats).  Minted walls are strictly
    increasing even when the physical clock stalls or steps backwards —
    the logical counter absorbs the anomaly (GentleRain+ §3)."""

    __slots__ = ("l", "c")

    def __init__(self, l: int = 0, c: int = 0):
        self.l = l
        self.c = c

    def mint(self, physical: float) -> float:
        pt = int(physical)
        if pt > self.l:
            self.l, self.c = pt, 0
        else:
            self.c += 1
            if self.c >= 1 << 20:           # counter overflow: borrow a tick
                self.l += 1
                self.c = 0
        return hlc_encode(self.l, self.c)

    def observe(self, wall: float) -> None:
        l2, c2 = hlc_decode(wall)
        if l2 > self.l:
            self.l, self.c = l2, c2
        elif l2 == self.l and c2 > self.c:
            self.c = c2

    def observe_physical(self, physical: float) -> None:
        pt = int(physical)
        if pt > self.l:
            self.l, self.c = pt, 0

    def read(self) -> float:
        return hlc_encode(self.l, self.c)

    def __repr__(self) -> str:      # pragma: no cover
        return f"HybridClock(l={self.l}, c={self.c})"


def resolution_key(v: Version) -> Tuple[float, str, str]:
    """The total order used to resolve concurrent siblings into a single
    register value: latest wall-time wins, clock repr then value repr break
    ties deterministically (documented in DESIGN.md §7)."""
    return (v.wall, repr(v.clock), repr(v.value))


def sync_versions(S1: FrozenSet[Version], S2: FrozenSet[Version],
                  total_order: bool = False) -> FrozenSet[Version]:
    """Paper §4 sync lifted to versions.

    ``total_order=True`` implements the LWW collapse: keep only the single
    maximal version (ties broken deterministically) — used by the wall-clock
    and Lamport baselines.
    """
    allv = S1 | S2
    if not allv:
        return frozenset()
    if total_order:
        best = None
        for v in sorted(allv, key=lambda v: repr(v.value)):
            if best is None or best.clock.lt(v.clock):
                best = v
        return frozenset({best})
    keep = set()
    for x in allv:
        dominated = any(
            x.clock.lt(y.clock) for y in allv if y is not x)
        duplicate = any(
            y.clock == x.clock and repr(y.value) < repr(x.value) for y in allv)
        if not dominated and not duplicate:
            keep.add(x)
    return frozenset(keep)


def clocks_of(S: FrozenSet[Version]) -> FrozenSet[Any]:
    return frozenset(v.clock for v in S)


def values_of(S: FrozenSet[Version]) -> Tuple[Any, ...]:
    return tuple(sorted((v.value for v in S), key=repr))
