"""Camera geometry: rotations, projection, two-view and PnP solvers.

The same names as ``sfm_tpu.geometry`` re-exports.  The JAX package's
``smallinv.py`` (closed-form 3x3 / 6x6 inverses, a TPU workaround) has no
counterpart: the port solves with ``torch.linalg`` (ROADMAP "State of the
port")."""

from .rotations import exp_so3, log_so3, hat, rotate_points
from .camera import (
    project, project_cam, apply_intrinsics, depths, pixel_to_norm,
    distort_norm, undistort_norm, undistort_pixels, distort_pixels,
    optimal_new_camera_matrix,
)
from .triangulate import projection_matrix, triangulate_pair, triangulate_nviews
from .epipolar import (
    essential_from_poses, fundamental_from_poses, epiline_distance_sq,
    filter_matches_epipolar, homography_transfer_error_sq, homography_score,
    fundamental_score, mean_transfer_error, mean_epipolar_error,
)
from .estimation import estimate_homography, estimate_fundamental
from .twoview import (
    decompose_essential, decompose_homography, cheirality_vote,
    recover_pose_from_essential, recover_pose_from_homography,
)
from .pnp import pnp_dlt, refine_pose, reprojection_errors
