"""idle_pct.train: the share of the window in which nothing ran on the
device: the traced block's device busy time per iteration over the window's
time per iteration, in % (the profiler's host cost stretches the traced
block itself, not the device's work in it)."""

from benchmark.metrics_common import idle_share


def read(record):
    return idle_share(record, "iteration")
