"""Totally-ordered clocks (paper §3.1 baselines): real-time LWW and Lamport.

Both establish a total order *compliant with* causality but collapse all
concurrency — the paper's Fig. 2 run shows concurrent updates being silently
dropped under last-writer-wins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet


@dataclass(frozen=True)
class WallClock:
    """Physical-timestamp clock (Cassandra v0.6 style).

    ``skew`` models a client with a persistently fast/slow clock; the paper
    notes such a client always wins / always loses.
    """

    t: float
    tiebreak: str = ""

    def leq(self, other: "WallClock") -> bool:
        return (self.t, self.tiebreak) <= (other.t, other.tiebreak)

    def lt(self, other: "WallClock") -> bool:
        return (self.t, self.tiebreak) < (other.t, other.tiebreak)

    def concurrent(self, other: "WallClock") -> bool:
        return False  # total order: nothing is ever concurrent

    def size(self) -> int:
        return 2


@dataclass(frozen=True)
class LamportClock:
    """(counter, site) pair ordered lexicographically (paper §3.1)."""

    counter: int
    site: str

    def leq(self, other: "LamportClock") -> bool:
        return (self.counter, self.site) <= (other.counter, other.site)

    def lt(self, other: "LamportClock") -> bool:
        return (self.counter, self.site) < (other.counter, other.site)

    def concurrent(self, other: "LamportClock") -> bool:
        return False

    def size(self) -> int:
        return 2


def lamport_update(context: FrozenSet[LamportClock], S_r: FrozenSet[LamportClock],
                   site: str) -> LamportClock:
    """Tag a new update: advance past everything seen locally or in context."""
    seen = max((c.counter for c in (context | S_r)), default=0)
    return LamportClock(seen + 1, site)


def lww_store(current, incoming):
    """Last-writer-wins register step: keep the larger clock's value."""
    cur_clock, _ = current
    inc_clock, _ = incoming
    return incoming if cur_clock.lt(inc_clock) else current
