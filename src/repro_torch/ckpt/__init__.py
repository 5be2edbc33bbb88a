"""Distributed checkpointing with DVV-tracked manifests: the shard codec,
the manifests and the manager that PUTs them into the store; the atomic
writes and checksums also serve the store's durable log."""
from .atomic import atomic_write_bytes
from .manager import CheckpointManager, RestoreResult
from .manifest import Manifest, ShardRecord, content_checksum, \
    resolve_manifest_siblings
from .shards import load_array, load_tree, save_array, save_tree

__all__ = [
    "CheckpointManager", "RestoreResult",
    "Manifest", "ShardRecord", "resolve_manifest_siblings",
    "save_array", "load_array", "save_tree", "load_tree",
    "atomic_write_bytes", "content_checksum",
]
