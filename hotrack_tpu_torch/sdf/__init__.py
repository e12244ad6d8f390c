from .decoder import SDFDecoder, WNLinear
from .distill import (
    DistilledSDF,
    distill_sdf_volume,
    eval_distilled_sdf,
    eval_distilled_sdf_cf,
)
from .volume import bake_sdf_volume, nearest_sdf, trilinear_sdf, volume_coords

__all__ = [
    "SDFDecoder", "WNLinear", "DistilledSDF", "distill_sdf_volume",
    "eval_distilled_sdf", "eval_distilled_sdf_cf", "bake_sdf_volume",
    "nearest_sdf", "trilinear_sdf", "volume_coords",
]
