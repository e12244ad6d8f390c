from .model import (
    KP_REORDER,
    PALM_KP_IDS,
    ManoModel,
    get_mano_model,
    load_mano_pkl,
    synthetic_mano_model,
)
from .layer import (
    mano_forward,
    mano_keypoints,
    mano_rodrigues,
    mano_skin_inputs,
    pca_comps2pose,
    shape_hand,
    template_keypoints,
)

__all__ = ["KP_REORDER", "PALM_KP_IDS", "ManoModel", "get_mano_model",
           "load_mano_pkl", "synthetic_mano_model", "mano_forward",
           "mano_keypoints", "mano_rodrigues", "mano_skin_inputs", "pca_comps2pose",
           "shape_hand", "template_keypoints"]
