"""FiLM weight decomposition (`gan_training/utils_model_load.py:151-205`),
as pure state-dict transforms.  Port of `rick_tpu/legacy/film.py`, which
is numpy only: a copy.

Decomposes weights into normalized bases plus per-row (fc) or per-filter
(conv) gamma/beta modulation parameters -- the GANmemory/AdaFM style-space
factorization the reference repo inherited."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def decompose_film_generator(sd: Dict[str, np.ndarray], stdd: float = 1.0) -> Tuple[Dict, Dict]:
    """Returns (normalized_sd, film_params).

    style fc weights -> per-row (mu, std); convs.*.conv.weight (5-D) ->
    per-(out,in) spatial (mu, std); to_rgbs modulation fc -> per-row.
    """
    out = dict(sd)
    film: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        v = np.asarray(v, np.float32)
        if k.startswith("style.") and k.endswith("weight"):
            mu = v.mean(axis=1, keepdims=True)
            std = v.std(axis=1, keepdims=True) * stdd
            out[k] = (v - mu) / std
            idx = k.split(".")[1]
            film[f"film_layer.{idx}.gamma"] = std.T
            film[f"film_layer.{idx}.beta"] = mu.T
        elif "convs" in k and k.endswith("conv.weight") and v.ndim == 5:
            mu = v.mean(axis=(3, 4), keepdims=True)
            std = v.std(axis=(3, 4), keepdims=True) * stdd
            out[k] = (v - mu) / std
            prefix = k[: k.find("conv.")]
            film[prefix + "conv.style_gamma"] = std
            film[prefix + "conv.style_beta"] = mu
        elif "to_rgbs" in k and k.endswith("modulation.weight"):
            mu = v.mean(axis=1, keepdims=True)
            std = v.std(axis=1, keepdims=True) * stdd
            out[k] = (v - mu) / std
            prefix = k[: k.find("conv.")]
            film[prefix + "conv.film_layer.gamma"] = std.T
            film[prefix + "conv.film_layer.beta"] = mu.T
    return out, film


def decompose_film_discriminator(sd: Dict[str, np.ndarray], stdd: float = 1.0) -> Tuple[Dict, Dict]:
    """D variant (`utils_model_load.py:189-205`): style fc layers only."""
    out = dict(sd)
    film: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        v = np.asarray(v, np.float32)
        if k.startswith("style.") and k.endswith("weight"):
            mu = v.mean(axis=1, keepdims=True)
            std = v.std(axis=1, keepdims=True) * stdd
            out[k] = (v - mu) / std
            idx = k.split(".")[1]
            film[f"film_layer.{idx}.gamma"] = std.T
            film[f"film_layer.{idx}.beta"] = mu.T
    return out, film


def compose_film_generator(sd: Dict[str, np.ndarray], film: Dict[str, np.ndarray]) -> Dict:
    """Inverse of decompose_film_generator: W = W_norm * std + mu."""
    out = dict(sd)
    for k, v in sd.items():
        v = np.asarray(v, np.float32)
        if k.startswith("style.") and k.endswith("weight"):
            idx = k.split(".")[1]
            std = film[f"film_layer.{idx}.gamma"].T
            mu = film[f"film_layer.{idx}.beta"].T
            out[k] = v * std + mu
        elif "convs" in k and k.endswith("conv.weight") and v.ndim == 5:
            prefix = k[: k.find("conv.")]
            out[k] = v * film[prefix + "conv.style_gamma"] + film[prefix + "conv.style_beta"]
        elif "to_rgbs" in k and k.endswith("modulation.weight"):
            prefix = k[: k.find("conv.")]
            out[k] = v * film[prefix + "conv.film_layer.gamma"].T + film[prefix + "conv.film_layer.beta"].T
    return out


def strip_module_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`load_weights_without_module` (`utils_model_load.py:26-40`): drop the
    DataParallel 'module.' key prefix."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
