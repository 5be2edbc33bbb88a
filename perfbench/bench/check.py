"""What a run hands back, and the arithmetic that decides ``correct``.

Each number compared is computed from the program's outputs and the plain
reference's, and held to the limit that the cell's check file gives it
(``checks/<cell>.json``: ``limits``); every other number a run reads is
kept under ``readings`` for the record and decides nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import torch


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the reference's best, per
    row: ref [N, V] float32, tokens [N]."""
    return ref.max(-1).values - ref.gather(
        -1, tokens.long().view(-1, 1))[:, 0]


def rel_errs(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's error as a share of the reference row's spread about
    its mean: ||got - ref|| / ||ref - mean(ref)||."""
    got, ref = got.float(), ref.float()
    return (got - ref).norm(dim=-1) / (
        ref - ref.mean(-1, keepdim=True)).norm(dim=-1)


def summary(prefix: str, values: torch.Tensor) -> Dict[str, float]:
    v = values.double().cpu()
    return {f"{prefix}_max": float(v.max()),
            f"{prefix}_p99": float(torch.quantile(v, 0.99)),
            f"{prefix}_median": float(v.median()),
            f"{prefix}_mean": float(v.mean())}


def worst_group(prefix: str, values: torch.Tensor, groups: torch.Tensor
                ) -> Dict[str, float]:
    """The largest over groups (a prompt, a slot) of each group's median
    and mean of ``values``: a fault confined to one group moves these
    where a median over all the rows does not see it."""
    v, g = values.double().cpu(), groups.cpu()
    stats = [(float(torch.quantile(x, 0.5)), float(x.mean()))
             for x in (v[g == k] for k in g.unique())]
    return {f"{prefix}_worst_median": max(s[0] for s in stats),
            f"{prefix}_worst_mean": max(s[1] for s in stats)}


@dataclass
class Outcome:
    """One run's results: the end-to-end values, what the per-layer
    readers read (``layer``), the numbers compared and the rest read."""
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    layer: Dict[str, object] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)
    control: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    segment: Optional[object] = None
    #: seconds since the process started at which each phase ended
    at_s: Dict[str, float] = field(default_factory=dict)

    def checks(self, limits: Mapping[str, float], control: bool = False
               ) -> List[List]:
        """[name, value, limit] for each number the cell compares; a
        number the run could not read counts as failed.  ``control``: the
        control's numbers where it has them (it takes the model's place,
        not the store's)."""
        numbers = dict(self.numbers, **self.control) if control \
            else self.numbers
        return [[name, numbers.get(name, float("inf")), limit]
                for name, limit in limits.items()]

    def readings(self, limits: Mapping[str, float]) -> Dict[str, float]:
        return {k: v for k, v in self.numbers.items() if k not in limits}


def correct(checks: List[List]) -> bool:
    return all(value <= limit for _, value, limit in checks)
