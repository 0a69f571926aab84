"""global_ba_tables_pct.long: the share of global BA's host time spent
building its tables, in %: the seconds in the program's
``global_ba.tables`` spans (the observations of every keyframe, the
landmark-major tables, the frozen-camera mask) over the seconds in its
``engine.global_ba`` spans, in the traced window.  None where the program
records no ``global_ba.tables`` span."""


def read(record):
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    total = tr.total_s("engine.global_ba")
    if total <= 0 or tr.calls("global_ba.tables") <= 0:
        return None
    return 100.0 * tr.total_s("global_ba.tables") / total
