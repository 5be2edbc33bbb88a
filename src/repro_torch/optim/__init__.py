from .adamw import (
    AdamWConfig, adamw_update, clip_by_global_norm, global_norm,
    init_opt_state, schedule_lr,
)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "schedule_lr",
           "global_norm", "clip_by_global_norm"]
