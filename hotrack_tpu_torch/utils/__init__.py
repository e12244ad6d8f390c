from .convert import (
    distilled_from_numpy,
    distilled_to_numpy,
    export_handtracknet,
    export_iknet,
    handtracknet_state_dict_from_flax,
    iknet_state_dict_from_flax,
    load_reference_checkpoint,
    save_reference_checkpoint,
    sdf_decoder_state_dict_from_flax,
)

__all__ = ["distilled_from_numpy", "distilled_to_numpy",
           "sdf_decoder_state_dict_from_flax", "export_handtracknet", "export_iknet",
           "handtracknet_state_dict_from_flax", "iknet_state_dict_from_flax",
           "load_reference_checkpoint", "save_reference_checkpoint"]
