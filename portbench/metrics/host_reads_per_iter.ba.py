"""host_reads_per_iter.ba: the times the host waited for the card, per LM
iteration completed in the traced window: the program's ``host_reads``
counter (its deliberate device-to-host reads) plus ``implicit_sync``
(the operations that synchronise on their own, counted where they
stand).  None where the program counts nothing."""


def read(record):
    try:
        from sfm_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    tr = RECORDER.trace()
    n = record.get("lm_iterations")
    if not n or not tr.spans:
        return None
    return (tr.counter("host_reads") + tr.counter("implicit_sync")) / n
