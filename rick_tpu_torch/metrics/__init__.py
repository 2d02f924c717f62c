"""Metrics: the in-loop FID/KID evaluator and what it is built from
(InceptionV3 pool3, torch-convention resizes, the Fréchet distance).  Port
of `rick_tpu/metrics/` (evaluator, fid, inception, resize)."""

from rick_tpu_torch.metrics.evaluator import Evaluator, kid_subsets
from rick_tpu_torch.metrics.fid import (
    activation_statistics,
    calculate_fid_given_images,
    calculate_frechet_distance,
    frechet_distance_device,
    get_activations,
)
from rick_tpu_torch.metrics.inception import (
    InceptionV3,
    default_inception_params,
    inception_from_params,
    inception_init_np,
    load_inception_params,
    randomize_bn,
)
from rick_tpu_torch.metrics.resize import bilinear_resize_torch, nearest_resize_torch

__all__ = [
    "Evaluator",
    "InceptionV3",
    "activation_statistics",
    "bilinear_resize_torch",
    "calculate_fid_given_images",
    "calculate_frechet_distance",
    "default_inception_params",
    "frechet_distance_device",
    "get_activations",
    "inception_from_params",
    "inception_init_np",
    "kid_subsets",
    "load_inception_params",
    "nearest_resize_torch",
    "randomize_bn",
]
