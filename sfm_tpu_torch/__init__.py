"""sfm_tpu_torch — the PyTorch/CUDA port of the sfm_tpu SLAM engine.

A second package beside the JAX one (``sfm_tpu``, the reference): the same
module layout, the same configuration, plain PyTorch on tensors, and every
TPU kernel on the main path rewritten as a CUDA kernel for Hopper
(``csrc/``, built at first use by ``native.py``).  It imports ``torch`` and
numpy, never JAX.
"""

__version__ = "0.1.0"

from .config import SfMConfig, DEFAULT_CONFIG


def __getattr__(name):
    # importing the engine pulls in the full stack; keep the package light
    if name == "SfMEngine":
        from .engine import SfMEngine
        return SfMEngine
    if name == "PointCloud":
        from .io import PointCloud
        return PointCloud
    raise AttributeError(name)
