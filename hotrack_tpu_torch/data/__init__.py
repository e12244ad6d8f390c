"""Data readers and batch preparation. schema.py, simgrasp.py and dataset.py
are numpy-only readers carried over from hotrack_tpu/data (whose package
imports JAX); only the SimGrasp reader is wired up in the port."""

from .schema import PRESUBSAMPLE_FACTOR, RawFrame, empty_frame, pad_points, stack_frames
from .pipeline import jitter_hand_kp, prepare_batch
from .dataset import SequenceData, SingleFrameData, get_dataloader, get_dataset

__all__ = ["PRESUBSAMPLE_FACTOR", "RawFrame", "empty_frame", "pad_points",
           "stack_frames", "jitter_hand_kp", "prepare_batch", "SequenceData",
           "SingleFrameData", "get_dataloader", "get_dataset"]
