"""Dotted version vectors (paper §5).

A DVV is a mapping from replica ids to either ``(m,)`` — a contiguous event
range ``1..m`` — or ``(m, n)`` — a range ``1..m`` plus one isolated "dot"
``n > m``.  The semantic function ``to_history`` maps clocks to causal
histories (§5.1); the partial order (§5.2) is inclusion of those histories,
computed component-wise without materializing them.

Representation: an immutable sorted tuple of ``(id, m, n)`` triples where
``n == 0`` encodes a plain (dotless) component.  ``m == 0`` with ``n > 0``
encodes a bare dot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Optional, Set, Tuple

from .causal_history import CausalHistory

Component = Tuple[str, int, int]  # (id, m, n); n == 0 means "no dot"


@dataclass(frozen=True)
class DVV:
    components: Tuple[Component, ...] = ()

    def __post_init__(self) -> None:
        seen = set()
        kept = []
        for (r, m, n) in self.components:
            if r in seen:
                raise ValueError(f"duplicate id {r!r} in DVV")
            seen.add(r)
            if m < 0 or n < 0:
                raise ValueError(f"negative counter in component {(r, m, n)}")
            if n != 0 and n <= m:
                raise ValueError(f"dot must satisfy n > m, got {(r, m, n)}")
            if m == 0 and n == 0:
                continue  # empty component represents no events — normalize away
            kept.append((r, m, n))
        object.__setattr__(self, "components", tuple(sorted(kept)))

    # -- construction ------------------------------------------------------
    @staticmethod
    def zero() -> "DVV":
        return DVV(())

    @staticmethod
    def from_dict(entries: Dict[str, Tuple[int, ...]]) -> "DVV":
        comps = []
        for r, v in entries.items():
            if len(v) == 1:
                comps.append((r, v[0], 0))
            else:
                comps.append((r, v[0], v[1]))
        return DVV(tuple(comps))

    # -- accessors ----------------------------------------------------------
    def ids(self) -> FrozenSet[str]:
        return frozenset(r for (r, _, _) in self.components)

    def component(self, r: str) -> Optional[Component]:
        for c in self.components:
            if c[0] == r:
                return c
        return None

    def ceil(self, r: str) -> int:
        """⌈C⌉_r — the maximum integer mapped from id ``r`` (paper §5.3)."""
        c = self.component(r)
        if c is None:
            return 0
        _, m, n = c
        return max(m, n)

    # -- semantics (paper §5.1) ----------------------------------------------
    def to_history(self) -> CausalHistory:
        events: Set[Tuple[str, int]] = set()
        for (r, m, n) in self.components:
            events.update((r, i) for i in range(1, m + 1))
            if n:
                events.add((r, n))
        return CausalHistory(frozenset(events))

    # -- partial order (paper §5.2) -------------------------------------------
    @staticmethod
    def _comp_leq(x: Component, y: Component) -> bool:
        """x ≤ y for two components with the same id."""
        rx, mx, nx = x
        ry, my, ny = y
        assert rx == ry
        if nx == 0 and ny == 0:   # (r,m) ≤ (r,m')
            return mx <= my
        if nx == 0:               # (r,m) ≤ (r,m',n')
            return mx <= my or (mx == my + 1 and mx == ny)
        if ny == 0:               # (r,m,n) ≤ (r,m')
            return nx <= my
        #                          (r,m,n) ≤ (r,m',n')
        return nx <= my or (mx <= my and nx == ny)

    def leq(self, other: "DVV") -> bool:
        """X ≤ Y ⟺ ∀x ∈ X. ∃y ∈ Y (same id). x ≤ y."""
        for x in self.components:
            y = other.component(x[0])
            if y is None or not self._comp_leq(x, y):
                return False
        return True

    def lt(self, other: "DVV") -> bool:
        return self.leq(other) and not other.leq(self)

    def concurrent(self, other: "DVV") -> bool:
        return not self.leq(other) and not other.leq(self)

    def dominates(self, other: "DVV") -> bool:
        return other.leq(self)

    # -- size (for the paper's scalability claims) ----------------------------
    def size(self) -> int:
        """Number of stored integers (2 per plain entry, 3 per dotted one)."""
        return sum(2 if n == 0 else 3 for (_, _, n) in self.components)

    def __repr__(self) -> str:
        parts = []
        for (r, m, n) in self.components:
            parts.append(f"({r},{m})" if n == 0 else f"({r},{m},{n})")
        return "{" + ", ".join(parts) + "}"


# ---------------------------------------------------------------------------
# Kernel operations (paper §4 instantiated for DVV, §5.3).
# ---------------------------------------------------------------------------

def ceil_set(S: Iterable[DVV], r: str) -> int:
    """⌈S⌉_r over a set of clocks."""
    return max((c.ceil(r) for c in S), default=0)


def ids_set(S: Iterable[DVV]) -> FrozenSet[str]:
    out: Set[str] = set()
    for c in S:
        out |= c.ids()
    return frozenset(out)


def update(S: FrozenSet[DVV], Sr: FrozenSet[DVV], r: str) -> DVV:
    """Mint the clock for a new PUT (paper §5.3).

    ``S`` is the client-supplied context, ``Sr`` the coordinator's current
    version set, ``r`` the coordinator id.  The result carries one dotted
    component (for ``r``) and plain components summarizing the context.
    """
    comps = []
    for i in sorted(ids_set(S) - {r}):
        comps.append((i, ceil_set(S, i), 0))
    m = ceil_set(S, r)
    n = ceil_set(Sr, r) + 1
    comps.append((r, m, n))
    return DVV(tuple(comps))


def sync(S1: FrozenSet[DVV], S2: FrozenSet[DVV]) -> FrozenSet[DVV]:
    """Merge two clock sets, discarding obsolete versions (paper §4).

    sync(S1,S2) = {x ∈ S1 | ¬∃y ∈ S2. x < y} ∪ {x ∈ S2 | ¬∃y ∈ S1. x < y}
    """
    keep1 = {x for x in S1 if not any(x.lt(y) for y in S2)}
    keep2 = {x for x in S2 if not any(x.lt(y) for y in S1)}
    return frozenset(keep1 | keep2)


def downset(S: Iterable[DVV]) -> bool:
    """The §5.4 invariant: the union of histories is downward closed."""
    from .causal_history import union_all

    S = list(S)
    hist = union_all(c.to_history() for c in S)
    for i in ids_set(S):
        top = ceil_set(S, i)
        for k in range(1, top + 1):
            if (i, k) not in hist.events:
                return False
    return True
