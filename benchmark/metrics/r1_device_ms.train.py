"""r1_device_ms.train: the device time of the R1 phase
(`train/steps.py::r1_phase`, the program's span `train.r1`) in the traced
block: each device record launched inside the span (`program_spans`), per
phase run, in ms."""

from benchmark.program_spans import ms_per_span


def read(record):
    return ms_per_span(record, "train.r1")
