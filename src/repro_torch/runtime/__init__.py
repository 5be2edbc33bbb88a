from .train_loop import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
