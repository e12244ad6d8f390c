from .procrustes import solve_rot_and_trans, solve_rot_and_trans_fast
from .rotations import matrix_to_unit_quaternion, rotvec_to_matrix

__all__ = ["solve_rot_and_trans", "solve_rot_and_trans_fast",
           "matrix_to_unit_quaternion", "rotvec_to_matrix"]
