"""FID: InceptionV3 pool3 activations on the device and the Fréchet distance.
Port of `rick_tpu/metrics/fid.py`.

Activations are taken in fixed batches (the set truncated to whole batches,
as the reference does); statistics in float64 on the host; the distance
either by scipy's `sqrtm` with the singular-product fallback (the
reference's math) or on the device in f32 by two symmetric
eigendecompositions.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy import linalg

from rick_tpu_torch.metrics.inception import InceptionV3


def _is_uint8(images) -> bool:
    return str(images.dtype) in ("uint8", "torch.uint8")


def get_activations(images, batch_size: int, model: InceptionV3, *,
                    stop_at=None, resize_to: int = 299) -> np.ndarray:
    """pool3 activations (float64, on the host) of NCHW images in [-1, 1], a
    numpy array or a tensor, in batches of `batch_size`, by `model` on its
    device; a trailing partial batch is dropped.  uint8 input is taken as raw
    pixels: it is uploaded as uint8 and dequantized to [-1, 1] on the
    device."""
    device = model.fc.weight.device
    batch_size = min(batch_size, images.shape[0])
    u8 = _is_uint8(images)
    outs = []
    with torch.inference_mode():
        for i in range(images.shape[0] // batch_size):
            chunk = torch.as_tensor(images[i * batch_size:(i + 1) * batch_size]).to(device)
            x = chunk.float() / 127.5 - 1.0 if u8 else chunk.float()
            outs.append(model.pool3(x, stop_at=stop_at, resize_to=resize_to).double())
    return torch.cat(outs).cpu().numpy()


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """The reference's `fid_score.py` math: scipy `sqrtm` of sigma1 . sigma2,
    retried with eps on the diagonals if the product is singular, and an
    error if the square root has a sizeable imaginary part."""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def frechet_distance_device(mu1, sigma1, mu2, sigma2) -> float:
    """The Fréchet distance in f32 on the device of `sigma1` (the CPU for a
    numpy array).  tr sqrtm(S1 S2) is taken as tr sqrt(A S2 A), A =
    sqrtm(S1): `eigh` of S1, then `eigvalsh` of the symmetrized A S2 A, both
    eigenvalue sets clipped at 0."""
    device = sigma1.device if isinstance(sigma1, torch.Tensor) else "cpu"
    mu1, sigma1, mu2, sigma2 = (torch.as_tensor(a).to(device=device, dtype=torch.float32)
                                for a in (mu1, sigma1, mu2, sigma2))
    diff = mu1 - mu2
    w1, v1 = torch.linalg.eigh(sigma1)
    a = (v1 * w1.clamp_min(0.0).sqrt()) @ v1.T  # sqrtm(S1)
    m = a @ sigma2 @ a
    w2 = torch.linalg.eigvalsh((m + m.T) / 2.0)
    tr_covmean = w2.clamp_min(0.0).sqrt().sum()
    return float(diff @ diff + sigma1.trace() + sigma2.trace() - 2.0 * tr_covmean)


def activation_statistics(images, batch_size: int, model: InceptionV3):
    act = get_activations(images, batch_size, model)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def calculate_fid_given_images(imgs0, imgs1, model: InceptionV3, batch_size: int = 64) -> float:
    """FID between two image sets by `model`, each set truncated to whole
    batches of min(batch_size, its size), as the reference does.  The
    distance runs on the model's device unless RICK_FID_HOST_SQRTM=1 selects
    scipy."""
    b0 = min(batch_size, imgs0.shape[0])
    b1 = min(batch_size, imgs1.shape[0])
    imgs0 = imgs0[: (imgs0.shape[0] // b0) * b0]
    imgs1 = imgs1[: (imgs1.shape[0] // b1) * b1]
    m1, s1 = activation_statistics(imgs0, b0, model)
    m2, s2 = activation_statistics(imgs1, b1, model)
    if os.environ.get("RICK_FID_HOST_SQRTM"):
        return calculate_frechet_distance(m1, s1, m2, s2)
    device = model.fc.weight.device
    return frechet_distance_device(*(torch.as_tensor(a, device=device) for a in (m1, s1, m2, s2)))
