"""Atomic writes and content-checksummed manifests, as the store's durable
log uses them.  The checkpoint manager and shard codec of the JAX package
are not ported yet (ROADMAP.md, Queue 1)."""
from .atomic import atomic_write_bytes
from .manifest import Manifest, ShardRecord, content_checksum, \
    resolve_manifest_siblings

__all__ = ["atomic_write_bytes", "Manifest", "ShardRecord",
           "content_checksum", "resolve_manifest_siblings"]
