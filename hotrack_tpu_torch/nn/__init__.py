from .backbones import PointNet2Encoder, PointNet2Msg
from .blocks import RearrangeModule, position_embedding_sine
from .pointnet2 import (
    FeaturePropagation,
    SetAbstractionAll,
    SetAbstractionAtCenters,
    SetAbstractionMsg,
)
from .point_transformer import (
    PointTransformerDownBlock,
    PointTransformerLayer,
    PointTransformerResBlock,
    PointTransformerTransitionDown,
    PointTransformerTransitionUp,
    PointTransformerUpBlock,
)
from .transformer import AttnModule, TransT

__all__ = ["PointNet2Encoder", "PointNet2Msg", "RearrangeModule", "position_embedding_sine",
           "FeaturePropagation", "SetAbstractionAll", "SetAbstractionAtCenters",
           "SetAbstractionMsg", "PointTransformerDownBlock", "PointTransformerLayer",
           "PointTransformerResBlock", "PointTransformerTransitionDown",
           "PointTransformerTransitionUp", "PointTransformerUpBlock", "AttnModule", "TransT"]
