"""Cluster control plane: membership, failure detection, elastic scaling,
straggler mitigation — all causality-tracked through the DVV store."""
from .elastic import Assignment, ElasticController
from .failure_detector import FailureDetector
from .membership import MEMBERSHIP_KEY, MemberView, MembershipService, NodeStatus
from .stealer import Lease, WorkStealer, resolve_lease_siblings

__all__ = [
    "MembershipService", "MemberView", "NodeStatus", "MEMBERSHIP_KEY",
    "FailureDetector", "ElasticController", "Assignment",
    "WorkStealer", "Lease", "resolve_lease_siblings",
]
