from .ops import (bwd_launches, bwd_path_launches, launches, reset_launches,
                  ssd_scan)

__all__ = ["ssd_scan", "launches", "bwd_launches", "bwd_path_launches",
           "reset_launches"]
