"""Bundle adjustment: Levenberg-Marquardt with analytic Jacobians and
Schur-complement landmark elimination (the dense solver)."""

from .residuals import (Observations, residuals_and_jacobians, huber_weights,
                        apply_pose_update)
from .core import (BAStats, run_ba, observations_from_keyframes,
                   compact_landmarks, compact_ba_problem,
                   scatter_back_landmarks)
