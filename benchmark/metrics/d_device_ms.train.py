"""d_device_ms.train: the device time of the D phase
(`train/steps.py::d_phase`, the program's span `train.d`) in the traced
block: each device record launched inside the span (`program_spans`), per
phase run, in ms."""

from benchmark.program_spans import ms_per_span


def read(record):
    return ms_per_span(record, "train.d")
