from .ops import gqa_flash_attention, launches, reset_launches

__all__ = ["gqa_flash_attention", "launches", "reset_launches"]
