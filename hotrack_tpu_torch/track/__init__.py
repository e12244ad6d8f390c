from .eval import eval_hand_sequence, eval_obj_sequence
from .hand import (track_hand_sequence, track_hand_sequences_batched,
                   track_hand_sequences_sharded)
from .obj import (track_obj_sequence, track_obj_sequences_batched,
                  track_obj_sequences_sharded, track_obj_with_shape_update)
from .stream import HandTracker, ObjTracker, serve_combined
from .types import HandTrackResult, ObjTrackResult

__all__ = ["eval_hand_sequence", "eval_obj_sequence", "track_hand_sequence",
           "track_hand_sequences_batched", "track_hand_sequences_sharded",
           "track_obj_sequence", "track_obj_sequences_batched", "track_obj_sequences_sharded",
           "track_obj_with_shape_update", "HandTracker", "ObjTracker", "serve_combined",
           "HandTrackResult", "ObjTrackResult"]
