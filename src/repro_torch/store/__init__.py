"""Replicated key-value store (paper §4.1) over a simulated network: the
port of the JAX package's store, layer for layer (data plane, gossip,
failure detection, geo tier, membership services, coalescing serving
plane).  Batched planes sweep survival on the cluster's ``device``."""
from .bulk import DeltaSyncStats, delta_antientropy
from .client import KVClient
from .cluster import GetResult, KVCluster, PutAck
from .context import CausalContext, EMPTY_CONTEXT
from .failure import FailureDetector, MembershipController
from .geo import GeoPlane
from .gossip import GossipDriver, WanShipper, cluster_converged
from .network import SimNetwork, Unavailable
from .packed import MergedRead, PackedPayload, PackedVersionStore, \
    StoreDigest, concat_payloads, key_bucket, quorum_merge_many, \
    split_payload
from .replica import ReplicaNode
from .services import MEMBERSHIP_KEY, Lease, MemberView, MembershipService, \
    NodeStatus, WorkStealer, resolve_lease_siblings
from .serving import ClosedLoopEngine, OpScheduler, PendingOp
from .sharding import HashRing, key_hash64, shard_of_key
from .version import HybridClock, Version, clocks_of, hlc_decode, \
    hlc_encode, sync_versions, values_of
from .wal import CrashFS, CrashPoint, DurableLog, LocalFS, ReplayStats, \
    SegmentLog

__all__ = [
    "KVCluster", "KVClient", "GetResult", "PutAck",
    "CausalContext", "EMPTY_CONTEXT",
    "SimNetwork", "Unavailable",
    "GossipDriver", "WanShipper", "cluster_converged",
    "FailureDetector", "MembershipController",
    "GeoPlane", "HybridClock", "hlc_encode", "hlc_decode",
    "OpScheduler", "PendingOp", "ClosedLoopEngine",
    "ReplicaNode", "Version", "sync_versions", "clocks_of", "values_of",
    "PackedVersionStore", "PackedPayload", "MergedRead",
    "quorum_merge_many",
    "StoreDigest", "DeltaSyncStats", "delta_antientropy", "key_bucket",
    "HashRing", "key_hash64", "shard_of_key",
    "concat_payloads", "split_payload",
    "DurableLog", "SegmentLog", "ReplayStats",
    "LocalFS", "CrashFS", "CrashPoint",
    "MembershipService", "MemberView", "NodeStatus", "MEMBERSHIP_KEY",
    "WorkStealer", "Lease", "resolve_lease_siblings",
]
