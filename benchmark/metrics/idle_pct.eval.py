"""idle_pct.eval: the share of the window in which nothing ran on the
device: the traced evaluation's device busy time over the window's time per
evaluation, in %."""

from benchmark.metrics_common import idle_share


def read(record):
    return idle_share(record, "evaluation")
