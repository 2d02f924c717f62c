"""fisher_busy_pct.train: the share of a Fisher round the device is busy
with it: the device time launched inside the program's span `fisher.round`
(`train/fisher.py::fisher_round`) in the traced block, per round, over
`fisher_ms.train`'s mean, the round timed alone untraced (the profiler
stretches the host's time, not the device's), in %."""

from benchmark.program_spans import ms_per_span


def read(record):
    busy, rounds = ms_per_span(record, "fisher.round"), record.window.spans.get("fisher")
    return 100.0 * busy / (1e3 * sum(rounds) / len(rounds)) if busy is not None and rounds else None
