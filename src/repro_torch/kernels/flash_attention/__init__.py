from .ops import gqa_flash_attention, bwd_launches, launches, reset_launches

__all__ = ["gqa_flash_attention", "launches", "bwd_launches",
           "reset_launches"]
