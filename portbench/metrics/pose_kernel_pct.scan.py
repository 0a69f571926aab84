"""pose_kernel_pct.scan: the share of the tracker's pose refinements made
by one launch of the pose kernel (``csrc/pose.cu``), in %: the program's
``pose_kernel`` counter over its ``pose_refine`` counter (a call of
``geometry.pnp.refine_pose`` or ``ransac.refined``), in the traced
window.  None where the program has no pose kernel (no ``pose_refine``
among its launch counters) or counts no refinement."""


def read(record):
    if "pose_refine" not in record.get("launches", {}):
        return None
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    calls = tr.counter("pose_refine")
    if calls <= 0:
        return None
    return 100.0 * tr.counter("pose_kernel") / calls
