from .model import (
    KP_REORDER,
    PALM_KP_IDS,
    ManoModel,
    get_mano_model,
    load_mano_pkl,
    synthetic_mano_model,
)
from .layer import mano_forward, mano_rodrigues, shape_hand

__all__ = ["KP_REORDER", "PALM_KP_IDS", "ManoModel", "get_mano_model",
           "load_mano_pkl", "synthetic_mano_model", "mano_forward",
           "mano_rodrigues", "shape_hand"]
