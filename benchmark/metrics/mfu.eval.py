"""mfu.eval: the model FLOPs of the window's evaluations (generation,
Inception, the covariance; `flops/`) over the window times the card's TF32
peak, in %."""

from benchmark.metrics_common import model_share


def read(record):
    return model_share(record, ("evaluation",))
