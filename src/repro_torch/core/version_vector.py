"""Classic version vectors (paper §3.2 / §3.3 baselines).

Two flavours are implemented, matching the paper's survey:

* ``VV`` with **per-server entries** (Dynamo-style, §3.2).  Its ``update``
  increments the coordinating replica's own entry.  This is a *plausible
  clock*: two clients writing through the same replica produce totally
  ordered clocks, so one concurrent update is silently linearized (Fig. 3).

* ``VV`` with **per-client entries** (§3.3).  Correct when clients are
  stateful (or read-your-writes holds) but the vector grows with the client
  population, and the *stateless-inferred* mode loses updates when a client
  switches replicas (Fig. 4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, Tuple

from .causal_history import CausalHistory

Entry = Tuple[str, int]


@dataclass(frozen=True)
class VV:
    """An immutable version vector: mapping id -> max counter."""

    entries: Tuple[Entry, ...] = ()

    def __post_init__(self) -> None:
        seen = set()
        kept = []
        for (r, c) in self.entries:
            if r in seen:
                raise ValueError(f"duplicate id {r!r}")
            seen.add(r)
            if c < 0:
                raise ValueError("negative counter")
            if c > 0:
                kept.append((r, c))
        object.__setattr__(self, "entries", tuple(sorted(kept)))

    @staticmethod
    def zero() -> "VV":
        return VV(())

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "VV":
        return VV(tuple(d.items()))

    def get(self, r: str) -> int:
        for (rr, c) in self.entries:
            if rr == r:
                return c
        return 0

    def ids(self) -> FrozenSet[str]:
        return frozenset(r for (r, _) in self.entries)

    def bump(self, r: str, to: int | None = None) -> "VV":
        new = dict(self.entries)
        new[r] = (self.get(r) + 1) if to is None else to
        return VV(tuple(new.items()))

    def merge(self, other: "VV") -> "VV":
        """Pointwise max (the join of the VV lattice)."""
        out = dict(self.entries)
        for (r, c) in other.entries:
            out[r] = max(out.get(r, 0), c)
        return VV(tuple(out.items()))

    # -- partial order -------------------------------------------------------
    def leq(self, other: "VV") -> bool:
        return all(c <= other.get(r) for (r, c) in self.entries)

    def lt(self, other: "VV") -> bool:
        return self.leq(other) and not other.leq(self)

    def concurrent(self, other: "VV") -> bool:
        return not self.leq(other) and not other.leq(self)

    def dominates(self, other: "VV") -> bool:
        return other.leq(self)

    # -- semantics (each entry (r, c) summarizes events r_1..r_c) -------------
    def to_history(self) -> CausalHistory:
        events = set()
        for (r, c) in self.entries:
            events.update((r, i) for i in range(1, c + 1))
        return CausalHistory(frozenset(events))

    def size(self) -> int:
        return 2 * len(self.entries)

    def __repr__(self) -> str:
        return "{" + ", ".join(f"({r},{c})" for (r, c) in self.entries) + "}"


def merge_all(vvs: Iterable[VV]) -> VV:
    acc = VV.zero()
    for v in vvs:
        acc = acc.merge(v)
    return acc


# ---------------------------------------------------------------------------
# §3.2 — per-server-entry update (Dynamo).  The coordinator merges the client
# context, then increments its *own* entry past everything it stores locally.
# The returned clock totally orders against any same-server sibling — the
# paper's false-dominance failure.
# ---------------------------------------------------------------------------

def update_per_server(context: VV, S_r: FrozenSet[VV], r: str) -> VV:
    local_max = max((v.get(r) for v in S_r), default=0)
    return context.bump(r, to=max(local_max, context.get(r)) + 1)


# ---------------------------------------------------------------------------
# §3.3 — per-client-entry update.
#   * stateful mode: the client supplies its own monotonic counter — accurate
#     but O(#clients) space.
#   * stateless/inferred mode: the server guesses the next counter from the
#     context plus local versions; switching replicas between writes repeats
#     a counter and loses an update (Fig. 4).
# ---------------------------------------------------------------------------

def update_per_client_stateful(context: VV, client: str, counter: int) -> VV:
    return context.bump(client, to=counter)


def update_per_client_inferred(context: VV, S_r: FrozenSet[VV], client: str) -> VV:
    local_max = max((v.get(client) for v in S_r), default=0)
    return context.bump(client, to=max(local_max, context.get(client)) + 1)


def sync_vv(S1: FrozenSet[VV], S2: FrozenSet[VV]) -> FrozenSet[VV]:
    """Generic §4 sync over the VV partial order."""
    keep1 = {x for x in S1 if not any(x.lt(y) for y in S2)}
    keep2 = {x for x in S2 if not any(x.lt(y) for y in S1)}
    return frozenset(keep1 | keep2)
