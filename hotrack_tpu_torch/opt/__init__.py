from .particle import (
    ParticleSpec,
    normalize_quat_head,
    presample_particles,
    quat_extend,
    run_particle_opt,
)
from .obj_pose import OBJ_SPEC, optimize_obj_pose
from .hand_shape import SHAPE_SPEC, kp2length, optimize_hand_shape
from .shape_update import estimate_normals, merge_observations, update_shape
from .hand_pose import (
    POSE_SPEC,
    ContactZones,
    load_contact_zones,
    optimize_hand_pose,
    world2point2d,
)

__all__ = [
    "ParticleSpec", "normalize_quat_head", "presample_particles",
    "quat_extend", "run_particle_opt", "OBJ_SPEC", "optimize_obj_pose",
    "SHAPE_SPEC", "kp2length", "optimize_hand_shape", "POSE_SPEC",
    "ContactZones", "load_contact_zones", "optimize_hand_pose",
    "world2point2d", "estimate_normals", "merge_observations", "update_shape",
]
