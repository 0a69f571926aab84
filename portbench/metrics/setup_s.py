"""setup_s: process start to the first timed call (loading, rendering or
making the inputs, the kernels' build or load, the warm-up)."""


def read(record):
    return record["setup_s"]
