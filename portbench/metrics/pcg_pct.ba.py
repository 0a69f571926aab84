"""pcg_pct.ba: the share of the solver's host time spent building and
running the preconditioned CG, in %: the seconds in the program's
``ba.pcg`` spans (the right-hand side, the preconditioner and the PCG
loop) over the seconds in its ``ba.solve`` spans, in the traced window.
None where the program records no span."""


def read(record):
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    solve = tr.total_s("ba.solve")
    if solve <= 0:
        return None
    return 100.0 * tr.total_s("ba.pcg") / solve
