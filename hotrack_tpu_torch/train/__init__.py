from .cli import test_main, train_main
from .run_hand_track import run_hand_tracking
from .trainer import (
    Trainer,
    bn_momentum_schedule,
    lr_schedule,
    make_optimizer,
    summarize_losses,
)

__all__ = ["test_main", "train_main", "run_hand_tracking", "Trainer",
           "bn_momentum_schedule", "lr_schedule", "make_optimizer",
           "summarize_losses"]
