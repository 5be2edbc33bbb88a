from .ops import bwd_launches, launches, reset_launches, ssd_scan

__all__ = ["ssd_scan", "launches", "bwd_launches", "reset_launches"]
