from .ops import launches, reset_launches, ssd_scan

__all__ = ["ssd_scan", "launches", "reset_launches"]
