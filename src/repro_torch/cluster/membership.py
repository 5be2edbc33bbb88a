"""Compat shim: the DVV-backed membership ledger was promoted to the store
plane (``repro_torch.store.services``), alongside the §13 liveness
controller it complements.  The training-sim runtime keeps importing it
from here; new code should import from ``repro_torch.store``.
"""
from __future__ import annotations

from ..store.services import MEMBERSHIP_KEY, MemberView, MembershipService, \
    NodeStatus

__all__ = ["MEMBERSHIP_KEY", "MemberView", "MembershipService", "NodeStatus"]
