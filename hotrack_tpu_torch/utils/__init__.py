from .convert import (
    handtracknet_state_dict_from_flax,
    load_reference_checkpoint,
    save_reference_checkpoint,
)

__all__ = ["handtracknet_state_dict_from_flax", "load_reference_checkpoint",
           "save_reference_checkpoint"]
