from .particle import (
    ParticleSpec,
    normalize_quat_head,
    presample_particles,
    quat_extend,
    run_particle_opt,
)
from .obj_pose import OBJ_SPEC, optimize_obj_pose

__all__ = ["ParticleSpec", "normalize_quat_head", "presample_particles",
           "quat_extend", "run_particle_opt", "OBJ_SPEC", "optimize_obj_pose"]
