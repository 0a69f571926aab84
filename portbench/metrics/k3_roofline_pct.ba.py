"""k3_roofline_pct.ba: K3's share of its roofline over the traced window,
in %: the summed bound of the window's Schur calls (a full apply for each
``schur_apply`` launch, a gather for each ``schur_gather`` launch, on the
problem's shapes) over the device time of schur.cu's kernels.  The modes
share ``camera_phase``, so the share is over the file's kernels
together."""

from portbench import core
from portbench.reference.roofline import ba_bound


def read(record):
    dev = core.file_time(record, "schur")
    if dev <= 0:
        return None
    shape = core.ba_shape(record)
    n = record["launches"]
    ms = sum(n.get(k, 0) * ba_bound(k, *shape)["bound_ms"]
             for k in ("schur_apply", "schur_gather", "schur_scatter"))
    return 100.0 * 1e-3 * ms / dev
