from .convert import (
    export_handtracknet,
    export_iknet,
    handtracknet_state_dict_from_flax,
    iknet_state_dict_from_flax,
    load_reference_checkpoint,
    save_reference_checkpoint,
)

__all__ = ["export_handtracknet", "export_iknet",
           "handtracknet_state_dict_from_flax", "iknet_state_dict_from_flax",
           "load_reference_checkpoint", "save_reference_checkpoint"]
