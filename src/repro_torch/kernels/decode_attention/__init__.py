from .ops import decode_attend, launches, reset_launches

__all__ = ["decode_attend", "launches", "reset_launches"]
