from .eval import eval_hand_sequence, eval_obj_sequence
from .hand import track_hand_sequence
from .obj import track_obj_sequence
from .types import HandTrackResult, ObjTrackResult

__all__ = ["eval_hand_sequence", "eval_obj_sequence", "track_hand_sequence",
           "track_obj_sequence", "HandTrackResult", "ObjTrackResult"]
