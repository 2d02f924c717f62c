"""Training: losses, Adam, freeze/prune masks, the four phases with the EMA,
the Fisher round, and the sample grids.  Port of `rick_tpu/train`."""

from rick_tpu_torch.train.fisher import accumulate_fims, fisher_round, masks_from_fims
from rick_tpu_torch.train.losses import d_logistic_loss, g_nonsaturating_loss, path_stats
from rick_tpu_torch.train.masks import merge_prune
from rick_tpu_torch.train.state import TrainConfig, TrainState, init_train_state, replicate_train_state
from rick_tpu_torch.train.steps import Draws, run_iteration, sample_draws, sample_images

__all__ = [
    "Draws",
    "TrainConfig",
    "TrainState",
    "accumulate_fims",
    "d_logistic_loss",
    "fisher_round",
    "g_nonsaturating_loss",
    "init_train_state",
    "masks_from_fims",
    "merge_prune",
    "path_stats",
    "replicate_train_state",
    "run_iteration",
    "sample_draws",
    "sample_images",
]
