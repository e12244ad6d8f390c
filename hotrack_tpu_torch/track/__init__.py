from .eval import eval_hand_sequence
from .hand import track_hand_sequence
from .types import HandTrackResult

__all__ = ["eval_hand_sequence", "track_hand_sequence", "HandTrackResult"]
