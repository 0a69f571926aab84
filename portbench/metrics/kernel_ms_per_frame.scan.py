"""kernel_ms_per_frame.scan: the device time of the port's hand-written
kernels (the nine __global__ functions of csrc/) in the traced window,
over the frames completed in it, in ms: kernel time beside the
host-bound wall."""

from portbench import core


def read(record):
    t, frames = record.get("trace"), record.get("frames")
    if not t or not frames:
        return None
    ms = 1e3 * sum(s for n, s in t["device_time"].items()
                   if core.kernel_file(n) is not None)
    return ms / len(frames) if ms > 0 else None
