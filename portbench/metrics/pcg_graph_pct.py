"""pcg_graph_pct.ba / .scan: the share of the solver's PCG solves played
as the replay of a captured CUDA graph, in %: the program's
``pcg_graph_replay`` counter over the calls of its ``ba.pcg`` span, in
the traced window (a capture happens once per problem shape, in set-up).
None where the program records no ``ba.pcg`` span or has no graph path."""


def read(record):
    try:
        from sfm_tpu_torch.ba import pcg_graph  # noqa: F401 - the graph path
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    calls = tr.calls("ba.pcg")
    if calls <= 0:
        return None
    return 100.0 * tr.counter("pcg_graph_replay") / calls
