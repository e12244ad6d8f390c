from .hand_network import HandTrackNet, hand_tracknet_loss, l1_loss, l2_loss
from .hand_utils import CanonPose, canonicalize, decanonicalize, handkp2palmkp, solve_hand_frame

__all__ = ["HandTrackNet", "hand_tracknet_loss", "l1_loss", "l2_loss",
           "CanonPose", "canonicalize", "decanonicalize", "handkp2palmkp",
           "solve_hand_frame"]
