"""ba_iter_ms: the window's milliseconds over the LM iterations completed
in it."""


def read(record):
    n = record.get("lm_iterations")
    if not n:
        return None
    return 1e3 * record["window_s"] / n
