"""Causal histories — the reference semantics for every clock mechanism.

Paper §3: "Causal histories are simply described by sets of unique update
event identifiers."  An event is ``(replica_id, counter)``; the partial order
is set inclusion.  Causal histories are exact but grow linearly with the
number of updates, so they serve as the *oracle* against which every compact
clock (version vectors, dotted version vectors, ...) is validated.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, Iterable, Tuple

Event = Tuple[str, int]  # (replica_id, counter), counters start at 1


@dataclass(frozen=True)
class CausalHistory:
    """An immutable set of update event identifiers."""

    events: FrozenSet[Event] = field(default_factory=frozenset)

    # -- construction ------------------------------------------------------
    @staticmethod
    def empty() -> "CausalHistory":
        return CausalHistory(frozenset())

    @staticmethod
    def of(*events: Event) -> "CausalHistory":
        return CausalHistory(frozenset(events))

    def add(self, event: Event) -> "CausalHistory":
        return CausalHistory(self.events | {event})

    def union(self, other: "CausalHistory") -> "CausalHistory":
        return CausalHistory(self.events | other.events)

    # -- partial order (paper §3: set inclusion) ---------------------------
    def leq(self, other: "CausalHistory") -> bool:
        return self.events <= other.events

    def lt(self, other: "CausalHistory") -> bool:
        return self.events < other.events

    def concurrent(self, other: "CausalHistory") -> bool:
        """A || B iff A ⊄ B and B ⊄ A (and A != B)."""
        return not self.leq(other) and not other.leq(self)

    def dominates(self, other: "CausalHistory") -> bool:
        return other.events <= self.events

    # -- helpers -----------------------------------------------------------
    def max_counter(self, replica: str) -> int:
        """Largest counter registered by ``replica`` (0 if none)."""
        return max((c for (r, c) in self.events if r == replica), default=0)

    def ids(self) -> FrozenSet[str]:
        return frozenset(r for (r, _) in self.events)

    def is_downset(self) -> bool:
        """True iff for each replica the events form a contiguous 1..k range."""
        for r in self.ids():
            counters = sorted(c for (rr, c) in self.events if rr == r)
            if counters != list(range(1, len(counters) + 1)):
                return False
        return True

    def size(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:  # {a1, a2, b1}
        inner = ", ".join(f"{r}{c}" for (r, c) in sorted(self.events))
        return "{" + inner + "}"


def union_all(histories: Iterable[CausalHistory]) -> CausalHistory:
    acc: FrozenSet[Event] = frozenset()
    for h in histories:
        acc |= h.events
    return CausalHistory(acc)
