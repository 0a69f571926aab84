"""read_wait_pct.scan and read_wait_pct.ba: the share of the host's time
spent waiting on the card, in %: the program's ``read_wait_s`` counter
(the seconds its device-to-host reads blocked) over the seconds in its
root spans (``engine.add_frames`` in a scan, ``ba.solve`` in a solve), in
the traced window.  None where the program records no span."""


def read(record):
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    root = tr.root_s()
    if root <= 0:
        return None
    return 100.0 * tr.counter("read_wait_s") / root
