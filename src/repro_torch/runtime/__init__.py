"""The training loop (``Trainer``) and the hot path's tracing
(``tracing``).  The models and the store import ``tracing``, and the
training loop imports the models, so the loop loads at first use."""
from importlib import import_module

__all__ = ["Trainer", "TrainerConfig"]


def __getattr__(name):
    if name in __all__:
        return getattr(import_module(".train_loop", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
