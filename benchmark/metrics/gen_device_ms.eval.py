"""gen_device_ms.eval: the device time of generation in the traced
evaluation: each device record launched inside the program's span
`eval.generate` (g_ema on a chunk, `metrics/evaluator.py::activations`),
per evaluation, in ms."""

from benchmark.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "eval.generate", "evaluation")
