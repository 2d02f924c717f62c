"""Metrics: the in-loop evaluator (FID, KID, precision/recall, intra-LPIPS)
and what it is built from (InceptionV3 pool3, VGG16 fc2 and LPIPS-VGG,
torch-convention resizes, the Fréchet distance, k-NN manifolds), the
stand-alone KID, Inception Score and LeNet features.  Port of
`rick_tpu/metrics/`."""

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
from rick_tpu_torch.metrics.inception_score import inception_score
from rick_tpu_torch.metrics.intra_lpips import IntraLPIPS, load_cluster_centers, prepare_cluster_centers
from rick_tpu_torch.metrics.kid import calculate_kid_given_images, polynomial_mmd_averages
from rick_tpu_torch.metrics.lenet import lenet_features, load_lenet_params
from rick_tpu_torch.metrics.lpips import default_lin_weights, load_lpips_lin_weights, lpips_distance
from rick_tpu_torch.metrics.precision_recall import IPR, Manifold
from rick_tpu_torch.metrics.resize import bilinear_resize_torch, nearest_resize_torch
from rick_tpu_torch.metrics.vgg import (
    VGG16,
    default_vgg16_params,
    load_vgg16_params,
    vgg16_fc2_features,
    vgg16_from_params,
    vgg16_init,
)

__all__ = [
    "Evaluator",
    "IPR",
    "InceptionV3",
    "IntraLPIPS",
    "Manifold",
    "VGG16",
    "activation_statistics",
    "bilinear_resize_torch",
    "calculate_fid_given_images",
    "calculate_frechet_distance",
    "calculate_kid_given_images",
    "default_inception_params",
    "default_lin_weights",
    "default_vgg16_params",
    "frechet_distance_device",
    "get_activations",
    "inception_from_params",
    "inception_init_np",
    "inception_score",
    "kid_subsets",
    "lenet_features",
    "load_cluster_centers",
    "load_inception_params",
    "load_lenet_params",
    "load_lpips_lin_weights",
    "load_vgg16_params",
    "lpips_distance",
    "nearest_resize_torch",
    "polynomial_mmd_averages",
    "prepare_cluster_centers",
    "randomize_bn",
    "vgg16_fc2_features",
    "vgg16_from_params",
    "vgg16_init",
]
