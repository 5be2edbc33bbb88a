"""Elastic scaling: map live membership onto a device mesh.

The controller consumes the DVV membership view, decides the largest valid
mesh that the live nodes support, and emits an ``Assignment`` (node → mesh
coordinates).  On scale events the training runtime restores from the last
DVV-checkpoint manifest and re-shards (resharding is a pure relayout because
checkpoints store logical arrays + a shard table, not device buffers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..store.services import MemberView


@dataclass(frozen=True)
class Assignment:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    node_coords: Tuple[Tuple[str, Tuple[int, ...]], ...]

    def coords_of(self, node: str) -> Optional[Tuple[int, ...]]:
        for n, c in self.node_coords:
            if n == node:
                return c
        return None

    @property
    def size(self) -> int:
        out = 1
        for s in self.mesh_shape:
            out *= s
        return out


def _unravel(i: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for s in reversed(shape):
        coords.append(i % s)
        i //= s
    return tuple(reversed(coords))


class ElasticController:
    """Chooses mesh shapes as nodes come and go.

    ``candidate_shapes`` is ordered largest-first; the controller picks the
    largest one that fits the live node count, preferring to keep the model
    axis intact (shrinking "model" would change the parameter sharding in
    ways that need a different partition rule table — we instead shed data
    parallelism first, the standard production response).
    """

    def __init__(self, candidate_shapes: Sequence[Tuple[Tuple[int, ...], Tuple[str, ...]]]):
        if not candidate_shapes:
            raise ValueError("need candidate shapes")
        self.candidate_shapes = list(candidate_shapes)

    def plan(self, view: MemberView) -> Optional[Assignment]:
        live = sorted(view.alive())
        for shape, names in self.candidate_shapes:
            size = 1
            for s in shape:
                size *= s
            if size <= len(live):
                coords = tuple(
                    (live[i], _unravel(i, shape)) for i in range(size))
                return Assignment(tuple(shape), tuple(names), coords)
        return None

    def replan_on_failure(self, view: MemberView,
                          current: Assignment) -> Tuple[Optional[Assignment], bool]:
        """Returns (new_assignment, changed?)."""
        new = self.plan(view)
        changed = (new is None or current is None
                   or new.mesh_shape != current.mesh_shape
                   or new.node_coords != current.node_coords)
        return new, changed
