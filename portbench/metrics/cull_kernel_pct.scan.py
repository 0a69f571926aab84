"""cull_kernel_pct.scan: the share of the mapping passes' keyframe culls
made by one launch of the cull kernel (``csrc/cull.cu``), in %: the
program's ``cull_kernel`` counter over the calls of its ``mapping.cull``
span, in the traced window.  None where the program has no cull kernel
(no ``cull_keyframes`` among its launch counters) or records no
``mapping.cull`` span."""


def read(record):
    if "cull_keyframes" not in record.get("launches", {}):
        return None
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    calls = tr.calls("mapping.cull")
    if calls <= 0:
        return None
    return 100.0 * tr.counter("cull_kernel") / calls
