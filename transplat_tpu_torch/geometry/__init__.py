from .epipolar import epipolar_sample_grid, inverse_depth_candidates, relative_pose
from .gaussians import build_covariance, quaternion_to_matrix
from .projection import (
    get_fov,
    get_world_rays,
    sample_image_grid,
    unnormalize_intrinsics,
    unproject,
)
from .sh import eval_sh, rotate_sh

__all__ = [
    "build_covariance",
    "epipolar_sample_grid",
    "eval_sh",
    "get_fov",
    "get_world_rays",
    "inverse_depth_candidates",
    "quaternion_to_matrix",
    "relative_pose",
    "rotate_sh",
    "sample_image_grid",
    "unnormalize_intrinsics",
    "unproject",
]
