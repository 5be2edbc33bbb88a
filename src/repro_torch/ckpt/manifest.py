"""Checkpoint manifests — the control-plane record of a checkpoint.

A manifest is what makes a pile of array shards a *checkpoint*: the step,
the shard table (logical path → file, shape, dtype), the data-pipeline
cursor and RNG state.  Manifests are small and live in the replicated DVV
store; shards are bulk bytes on (simulated) blob storage.

The failure mode this guards against: after a network partition, two
coordinators can both finalize "step-N" manifests built from different
worker subsets.  Under LWW one lineage silently vanishes (and its shards
leak / the restore mixes lineages).  Under DVV both manifests surface as
siblings at read time and ``resolve_manifest_siblings`` picks a winner
deterministically — every node restores the *same* lineage.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


def content_checksum(data: bytes) -> str:
    """The integrity stamp shared by shard blobs and WAL artifacts.

    16 hex chars of sha256 — short enough to live inline in manifests,
    long enough that a torn or corrupted blob cannot collide in practice.
    """
    return hashlib.sha256(data).hexdigest()[:16]


@dataclass(frozen=True)
class ShardRecord:
    path: str           # logical parameter path, e.g. "layers/attn/wq"
    file: str           # blob name
    shape: Tuple[int, ...]
    dtype: str
    checksum: str       # content hash — restores verify integrity


@dataclass(frozen=True)
class Manifest:
    run_id: str
    step: int
    shards: Tuple[ShardRecord, ...]
    data_cursor: int            # tokens consumed — pipeline resume point
    rng_seed: int
    rng_fold: int               # step-folded key state
    mesh_shape: Tuple[int, ...]
    writer: str                 # which coordinator finalized it
    parent_checksum: str = ""   # lineage link to previous manifest

    def serialize(self) -> str:
        d = {
            "run_id": self.run_id, "step": self.step,
            "shards": [vars(s) for s in self.shards],
            "data_cursor": self.data_cursor,
            "rng_seed": self.rng_seed, "rng_fold": self.rng_fold,
            "mesh_shape": list(self.mesh_shape), "writer": self.writer,
            "parent_checksum": self.parent_checksum,
        }
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def deserialize(s: str) -> "Manifest":
        d = json.loads(s)
        shards = tuple(
            ShardRecord(path=r["path"], file=r["file"],
                        shape=tuple(r["shape"]), dtype=r["dtype"],
                        checksum=r["checksum"])
            for r in d["shards"])
        return Manifest(
            run_id=d["run_id"], step=d["step"], shards=shards,
            data_cursor=d["data_cursor"], rng_seed=d["rng_seed"],
            rng_fold=d["rng_fold"], mesh_shape=tuple(d["mesh_shape"]),
            writer=d["writer"], parent_checksum=d["parent_checksum"])

    def checksum(self) -> str:
        return content_checksum(self.serialize().encode())


def resolve_manifest_siblings(manifests: Tuple[Manifest, ...]) -> Manifest:
    """Deterministic reconciliation of concurrent checkpoint lineages.

    Policy: highest step wins (most progress); ties broken by the lineage
    whose content hash is lexicographically smallest — arbitrary but
    *identical on every node*, which is the property that matters.
    """
    return sorted(manifests, key=lambda m: (-m.step, m.checksum()))[0]
