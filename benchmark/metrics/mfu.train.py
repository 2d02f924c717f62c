"""mfu.train: the model FLOPs of the window's phases and Fisher rounds
(counted once from the reference's shapes, `flops/`) over the window times
the card's TF32 peak, in %."""

from benchmark.metrics_common import model_share


def read(record):
    return model_share(record, ("d", "r1", "g", "path", "fisher_round"))
