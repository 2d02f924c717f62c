"""Functional equivalents of the reference's legacy GAN_stability /
GANmemory helpers (`gan_training/{checkpoints,logger,inputs,ops,
distributions,utils_model_load}.py`).  Port of `rick_tpu/legacy`: not on
the training path, but part of the API surface."""

from rick_tpu_torch.legacy.checkpoints import CheckpointIO
from rick_tpu_torch.legacy.distributions import get_ydist, get_zdist, interpolate_sphere
from rick_tpu_torch.legacy.logger import Logger
from rick_tpu_torch.legacy.model_utils import get_parameter_number, save_feature_map
from rick_tpu_torch.legacy.ops import cbatch_norm_apply, cinstance_norm_apply, spectral_norm_apply

__all__ = [
    "get_zdist",
    "get_ydist",
    "interpolate_sphere",
    "CheckpointIO",
    "Logger",
    "spectral_norm_apply",
    "cbatch_norm_apply",
    "cinstance_norm_apply",
    "get_parameter_number",
    "save_feature_map",
]
