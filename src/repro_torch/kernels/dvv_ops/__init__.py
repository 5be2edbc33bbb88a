from .ops import (
    BucketedReadSweep, BucketedSweep, antientropy_obsolete, dvv_concurrent,
    dvv_dominates, dvv_leq, dvv_read_sweep, dvv_read_sweep_bucketed,
    dvv_sync_mask, dvv_sync_mask_bucketed, launches, reset_launches,
)

__all__ = ["dvv_leq", "dvv_dominates", "dvv_concurrent",
           "antientropy_obsolete", "dvv_sync_mask", "dvv_sync_mask_bucketed",
           "dvv_read_sweep", "dvv_read_sweep_bucketed", "BucketedSweep",
           "BucketedReadSweep", "launches", "reset_launches"]
