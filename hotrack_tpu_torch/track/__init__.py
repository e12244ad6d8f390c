from .eval import eval_hand_sequence, eval_obj_sequence
from .hand import track_hand_sequence, track_hand_sequences_batched
from .obj import track_obj_sequence, track_obj_sequences_batched
from .stream import HandTracker, ObjTracker, serve_combined
from .types import HandTrackResult, ObjTrackResult

__all__ = ["eval_hand_sequence", "eval_obj_sequence", "track_hand_sequence",
           "track_hand_sequences_batched", "track_obj_sequence",
           "track_obj_sequences_batched", "HandTracker", "ObjTracker", "serve_combined",
           "HandTrackResult", "ObjTrackResult"]
