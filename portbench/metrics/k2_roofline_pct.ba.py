"""k2_roofline_pct.ba: K2's share of its roofline over the traced window,
in %: one linearisation's bound (on the problem's shapes) for each
``ba_linearize`` launch, over the device time of linearize.cu's two
kernels."""

from portbench import core
from portbench.reference.roofline import ba_bound


def read(record):
    dev = core.file_time(record, "linearize")
    if dev <= 0:
        return None
    ms = record["launches"].get("ba_linearize", 0) * ba_bound(
        "ba_linearize", *core.ba_shape(record))["bound_ms"]
    return 100.0 * 1e-3 * ms / dev
