"""Launchers: mesh construction, sharding rules, the dry run, the train,
prefill and decode steps, the training launcher (``launch.train``) and the
batched serving loop (``launch.serve``)."""
from .mesh import make_mesh, make_production_mesh
from .sharding import Sharder
from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["make_production_mesh", "make_mesh", "Sharder",
           "make_train_step", "make_prefill_step", "make_decode_step"]
