from .ops import (bwd_instance_launches, bwd_launches, gqa_flash_attention,
                  instance_launches, launches, reset_launches)

__all__ = ["gqa_flash_attention", "launches", "bwd_launches",
           "instance_launches", "bwd_instance_launches", "reset_launches"]
