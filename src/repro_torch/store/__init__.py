"""Replicated key-value store (paper §4.1) over a simulated network: the
data plane of the port (PUT, delta anti-entropy, quorum GET).  The gossip,
failure, geo, services and serving layers of the JAX package are not
ported yet (ROADMAP.md, Queue 1)."""
from .bulk import DeltaSyncStats, delta_antientropy
from .client import KVClient
from .cluster import GetResult, KVCluster, PutAck
from .context import CausalContext, EMPTY_CONTEXT
from .network import SimNetwork, Unavailable
from .packed import MergedRead, PackedPayload, PackedVersionStore, \
    StoreDigest, concat_payloads, key_bucket, quorum_merge_many, \
    split_payload
from .replica import ReplicaNode
from .sharding import HashRing, key_hash64, shard_of_key
from .version import HybridClock, Version, clocks_of, hlc_decode, \
    hlc_encode, sync_versions, values_of
from .wal import CrashFS, CrashPoint, DurableLog, LocalFS, ReplayStats, \
    SegmentLog

__all__ = [
    "KVCluster", "KVClient", "GetResult", "PutAck",
    "CausalContext", "EMPTY_CONTEXT",
    "SimNetwork", "Unavailable",
    "HybridClock", "hlc_encode", "hlc_decode",
    "ReplicaNode", "Version", "sync_versions", "clocks_of", "values_of",
    "PackedVersionStore", "PackedPayload", "MergedRead",
    "quorum_merge_many",
    "StoreDigest", "DeltaSyncStats", "delta_antientropy", "key_bucket",
    "HashRing", "key_hash64", "shard_of_key",
    "concat_payloads", "split_payload",
    "DurableLog", "SegmentLog", "ReplayStats",
    "LocalFS", "CrashFS", "CrashPoint",
]
