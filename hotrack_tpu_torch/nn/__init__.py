from .backbones import PointNet2Msg
from .blocks import RearrangeModule, position_embedding_sine
from .pointnet2 import (
    FeaturePropagation,
    SetAbstractionAll,
    SetAbstractionAtCenters,
    SetAbstractionMsg,
)
from .transformer import AttnModule, TransT

__all__ = ["PointNet2Msg", "RearrangeModule", "position_embedding_sine",
           "FeaturePropagation", "SetAbstractionAll", "SetAbstractionAtCenters",
           "SetAbstractionMsg", "AttnModule", "TransT"]
