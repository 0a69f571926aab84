"""tracking_pct.scan: the share of the engine's host time spent tracking,
in %: the seconds in the program's ``engine.track`` spans, less any
``engine.mapping`` nested in them (the inline mapping pass), over the
seconds in its root spans (``engine.add_frames``), in the traced window.
None where the program records no span."""


def read(record):
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    root = tr.root_s()
    if root <= 0:
        return None
    track = tr.total_s("engine.track") - tr.nested_s("engine.mapping",
                                                      "engine.track")
    return 100.0 * track / root
