"""Checkpoint manager: save/restore/reconcile through the DVV store.

save():    write shards to blob storage, then PUT the manifest with the
           causal context of the last manifest read — the new checkpoint
           *dominates* its parent, so replicas discard the old one on sync.
restore(): GET the manifest; if concurrent lineages surface as siblings
           (post-partition), resolve deterministically, write the
           resolution back (so it dominates both branches), and load shards.

The manager also keeps a bounded number of shard generations (keep_n) and
never deletes shards referenced by any *visible* manifest sibling — GC of a
losing lineage happens only after the resolution write dominates it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, TYPE_CHECKING, Tuple

import numpy as np

# Submodule imports (not the repro.store package) so the store's durable
# log can depend on ckpt helpers without an import cycle.
from ..store.network import Unavailable
from .manifest import Manifest, resolve_manifest_siblings
from .shards import load_tree, save_tree

if TYPE_CHECKING:
    from ..store.cluster import KVCluster


def _manifest_key(run_id: str) -> str:
    return f"ckpt/{run_id}/manifest"


@dataclass
class RestoreResult:
    manifest: Manifest
    arrays: Dict[str, np.ndarray]
    had_conflict: bool


class CheckpointManager:
    def __init__(self, store: KVCluster, blob_root: str, run_id: str,
                 node_id: str, keep_n: int = 2):
        self.store = store
        self.blob_root = blob_root
        self.run_id = run_id
        self.node_id = node_id
        self.keep_n = keep_n
        self._last_context: FrozenSet = frozenset()
        self._parent_checksum = ""

    # -- save ------------------------------------------------------------------
    def save(self, step: int, arrays: Dict[str, np.ndarray], *,
             data_cursor: int, rng_seed: int, rng_fold: int,
             mesh_shape: Tuple[int, ...], via: Optional[str] = None) -> Manifest:
        via = via or self.node_id
        records = save_tree(self.blob_root, self.run_id, step, arrays,
                            writer=self.node_id)
        manifest = Manifest(
            run_id=self.run_id, step=step, shards=records,
            data_cursor=data_cursor, rng_seed=rng_seed, rng_fold=rng_fold,
            mesh_shape=mesh_shape, writer=self.node_id,
            parent_checksum=self._parent_checksum)
        self.store.put(_manifest_key(self.run_id), manifest.serialize(),
                       context=self._last_context, via=via,
                       client_id=self.node_id)
        # our own write becomes the causal context for the next save
        res = self.store.get(_manifest_key(self.run_id), via=via)
        self._last_context = res.context
        self._parent_checksum = manifest.checksum()
        self._gc(keep_step=step)
        return manifest

    # -- restore -----------------------------------------------------------------
    def restore(self, *, via: Optional[str] = None,
                verify: bool = True) -> Optional[RestoreResult]:
        via = via or self.node_id
        try:
            res = self.store.get(_manifest_key(self.run_id), via=via)
        except Unavailable:
            return None
        if not res.values:
            return None
        # Dedupe by content: two nodes concurrently writing back the *same*
        # resolution produces concurrent clocks over identical manifests —
        # an artifact of the merge protocol, not a divergence.
        manifests = tuple(
            Manifest.deserialize(v) for v in sorted(set(res.values)))
        had_conflict = len(manifests) > 1
        chosen = resolve_manifest_siblings(manifests)
        if len(res.values) > 1:
            # write the resolution back with full context: it dominates both
            # lineages, so every replica converges on one checkpoint.
            self.store.put(_manifest_key(self.run_id), chosen.serialize(),
                           context=res.context, via=via,
                           client_id=self.node_id)
            res = self.store.get(_manifest_key(self.run_id), via=via)
        self._last_context = res.context
        self._parent_checksum = chosen.checksum()
        arrays = load_tree(self.blob_root, chosen.shards, verify=verify)
        return RestoreResult(manifest=chosen, arrays=arrays,
                             had_conflict=had_conflict)

    # -- GC ------------------------------------------------------------------------
    def _gc(self, keep_step: int) -> None:
        """Drop shard generations older than the keep_n newest present on
        disk, never touching files referenced by any visible manifest
        sibling.

        Conservative by construction: during a partition this node cannot
        see the other side's manifests, so visibility-based GC would delete
        blobs a divergent lineage still needs (observed in
        tests/test_fault_tolerance.py).  Retaining the newest keep_n
        *on-disk generations* bounds the race to operators setting keep_n
        below the maximum expected partition duration in checkpoints."""
        try:
            res = self.store.get(_manifest_key(self.run_id), via=self.node_id)
            referenced = set()
            for v in res.values:
                referenced |= {s.file
                               for s in Manifest.deserialize(v).shards}
        except Unavailable:
            referenced = set()
        if not os.path.isdir(self.blob_root):
            return
        prefix = f"{self.run_id}-step"

        def blob_step(fname: str):
            try:
                return int(fname[len(prefix):len(prefix) + 8])
            except ValueError:
                return None

        on_disk = [f for f in os.listdir(self.blob_root)
                   if f.startswith(prefix) and blob_step(f) is not None]
        generations = sorted({blob_step(f) for f in on_disk})
        keep_steps = set(generations[-self.keep_n:]) | {keep_step}
        for fname in on_disk:
            if fname in referenced or blob_step(fname) in keep_steps:
                continue
            try:
                os.unlink(os.path.join(self.blob_root, fname))
            except OSError:
                continue
