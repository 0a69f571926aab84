"""mapping_pct.scan: the share of the engine's host time spent in the
mapping pass, in %: the seconds in the program's ``engine.mapping`` spans
over the seconds in its root spans (``engine.add_frames``), in the traced
window.  None where the program records no span."""


def read(record):
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    root = tr.root_s()
    if root <= 0:
        return None
    return 100.0 * tr.total_s("engine.mapping") / root
