"""Launchers: the train, prefill and decode steps, the training launcher
(``launch.train``) and the batched serving loop (``launch.serve``).  The
mesh and the dry run are not ported yet (ROADMAP Queue 1 item 8)."""
from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]
