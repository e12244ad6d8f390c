"""Data readers and batch preparation. schema.py, simgrasp.py, ho3d.py,
dexycb.py and dataset.py are the host readers carried over from
hotrack_tpu/data (whose package imports JAX); image.py reads and writes the
PNG files they need without OpenCV or Pillow, and real_trees.py writes HO3D-
and DexYCB-layout trees for tests and the smoke test."""

from .schema import PRESUBSAMPLE_FACTOR, RawFrame, empty_frame, pad_points, stack_frames
from .pipeline import jitter_hand_kp, prepare_batch
from .dataset import SequenceData, SingleFrameData, get_dataloader, get_dataset

__all__ = ["PRESUBSAMPLE_FACTOR", "RawFrame", "empty_frame", "pad_points",
           "stack_frames", "jitter_hand_kp", "prepare_batch", "SequenceData",
           "SingleFrameData", "get_dataloader", "get_dataset"]
