"""The card's idle share of the traced window, in %: 1 - (the union of
its kernel, copy and fill intervals) / the window."""

from portbench import core


def read(record):
    return core.idle_pct(record)
