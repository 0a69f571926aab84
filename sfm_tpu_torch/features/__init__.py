"""Image features: detection, description and matching.

The names ``sfm_tpu.features`` re-exports, from the port's modules.  Four
of them are replaced by design (ROADMAP "State of the port"): ``describe``,
``orientation`` and ``bilinear`` (the pyramid path) are
``descriptor.describe_canvas`` through K5, and ``match_features`` is
``match_pallas.match_features_pallas`` through K1.  ``smooth`` is imported
on first use, since its module loads the kernels' builder (``native``)."""

from .detect import Keypoints, detect, fast_score, nms, shi_tomasi_score
from .flow import build_pyramid
from .bits import unpack_bits, pack_bits, hamming_matrix, hamming_pairwise
from .match import MatchResult, match_pairs


def __getattr__(name):
    if name == "smooth":
        from .descriptor import smooth
        return smooth
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
