"""Compat shim: ``FailureDetector`` was promoted to a first-class store
citizen (``repro_torch.store.failure``), where it drives the self-driving
membership loop (DESIGN.md §13).  The training-sim runtime keeps importing
it from here; new code should import from ``repro_torch.store``.
"""
from __future__ import annotations

from ..store.failure import FailureDetector

__all__ = ["FailureDetector"]
