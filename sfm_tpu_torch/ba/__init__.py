"""Bundle adjustment: Levenberg-Marquardt with analytic Jacobians and
Schur-complement landmark elimination: the dense solver and the
per-observation PCG solver (``core.py``), and the implicit-Schur PCG solver
(``large.py``, with its kernels K2 in ``linearize_pallas.py`` and K3 in
``schur_pallas.py``)."""

from .residuals import (Observations, residuals_and_jacobians, huber_weights,
                        apply_pose_update)
from .core import (BAStats, run_ba, run_ba_cg,
                   observations_from_keyframes, compact_landmarks,
                   compact_ba_problem, scatter_back_landmarks)
