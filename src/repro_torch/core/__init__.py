"""Core causality-tracking library (the paper's contribution).

Exports the dotted-version-vector clock (paper §5), the §4 kernel
(sync/update + formal conditions), the §3 baseline mechanisms, and the
batched array encoding used by the CUDA kernels.
"""
from .causal_history import CausalHistory, union_all
from .dvv import DVV, downset, sync, update
from .kernel import (
    ALL_MECHANISMS,
    DVV_MECHANISM,
    LAMPORT_MECHANISM,
    Mechanism,
    VV_CLIENT_INFERRED_MECHANISM,
    VV_CLIENT_MECHANISM,
    VV_SERVER_MECHANISM,
    WALLCLOCK_MECHANISM,
    antichain,
    generic_sync,
    sync_conditions_hold,
    update_conditions_hold_histories,
)
from .lww import LamportClock, WallClock, lamport_update
from .version_vector import VV, merge_all, sync_vv

__all__ = [
    "CausalHistory", "union_all",
    "DVV", "downset", "sync", "update",
    "VV", "merge_all", "sync_vv",
    "LamportClock", "WallClock", "lamport_update",
    "Mechanism", "ALL_MECHANISMS", "DVV_MECHANISM", "VV_SERVER_MECHANISM",
    "VV_CLIENT_MECHANISM", "VV_CLIENT_INFERRED_MECHANISM",
    "LAMPORT_MECHANISM", "WALLCLOCK_MECHANISM",
    "antichain", "generic_sync",
    "sync_conditions_hold", "update_conditions_hold_histories",
]
