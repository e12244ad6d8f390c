from .cli import test_main
from .run_hand_track import run_hand_tracking

__all__ = ["test_main", "run_hand_tracking"]
