"""inception_device_ms.eval: the device time of Inception in the traced
evaluation: each device record launched inside the program's span
`eval.inception` (pool3 of a chunk, `metrics/evaluator.py::activations`),
per evaluation, in ms."""

from benchmark.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "eval.inception", "evaluation")
