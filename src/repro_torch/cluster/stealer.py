"""Compat shim: the DVV-backed work-stealing lease ledger was promoted to
the store plane (``repro_torch.store.services``).  The training-sim
runtime keeps importing it from here; new code should import from
``repro_torch.store``.
"""
from __future__ import annotations

from ..store.services import Lease, WorkStealer, resolve_lease_siblings

__all__ = ["Lease", "WorkStealer", "resolve_lease_siblings"]
