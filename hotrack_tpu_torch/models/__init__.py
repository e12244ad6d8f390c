from .hand_network import (
    HandTrackNet,
    IKNet,
    hand_tracknet_loss,
    iknet_loss,
    iknet_predict_kp,
    l1_loss,
    l2_loss,
)
from .hand_utils import CanonPose, canonicalize, decanonicalize, handkp2palmkp, solve_hand_frame

__all__ = ["HandTrackNet", "IKNet", "hand_tracknet_loss", "iknet_loss",
           "iknet_predict_kp", "l1_loss", "l2_loss",
           "CanonPose", "canonicalize", "decanonicalize", "handkp2palmkp",
           "solve_hand_frame"]
