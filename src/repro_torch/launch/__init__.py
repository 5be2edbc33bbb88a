"""Launchers of the serving path: the prefill and decode steps and the
batched serving loop.  Training, the mesh and the dry run are not ported
yet (ROADMAP Queue 1 items 7-8)."""
from .steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
