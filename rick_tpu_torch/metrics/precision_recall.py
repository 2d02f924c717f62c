"""Improved precision and recall (Kynkäänniemi et al.): k-NN manifolds over
VGG16 fc2 features.  Port of `rick_tpu/metrics/precision_recall.py`.

A manifold is a set of features and, for each, the radius of its ball: the
distance to its k-th nearest neighbour, self excluded (k = 3).  Precision is
the fraction of generated samples inside some real ball, recall the fraction
of real samples inside some generated ball.

The numpy functions (`compute_pairwise_distances`, `distances2radii`,
`compute_metric`, `realism`) are `rick_tpu`'s, the plain versions.  `IPR`
and the evaluator take the device path: the same formula in f64 on the
features' device (|x|^2 - 2 x.y + |y|^2, clipped at 0, square root), the
radii by `torch.topk`.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from rick_tpu_torch.metrics.fid import _is_uint8
from rick_tpu_torch.metrics.vgg import default_vgg16_params, vgg16_fc2_features, vgg16_from_params

Manifold = namedtuple("Manifold", ["features", "radii"])
PrecisionAndRecall = namedtuple("PrecisionAndRecall", ["precision", "recall"])


def compute_pairwise_distances(X, Y=None) -> np.ndarray:
    """Euclidean distance matrix in float64 (`precision_recall.py:185-220`)."""
    X = np.asarray(X, np.float64)
    Y = X if Y is None else np.asarray(Y, np.float64)
    x2 = np.sum(X**2, axis=1, keepdims=True)
    y2 = np.sum(Y**2, axis=1, keepdims=True)
    d2 = x2 - 2 * X.dot(Y.T) + y2.T
    np.clip(d2, 0, None, out=d2)
    return np.sqrt(d2)


def distances2radii(distances: np.ndarray, k: int = 3) -> np.ndarray:
    """The k-th nearest neighbour's distance of each row, self excluded
    (`:223-236`): the (k+1)-th smallest entry, self included."""
    n = distances.shape[0]
    radii = np.zeros(n)
    for i in range(n):
        idx = np.argpartition(distances[i], k + 1)
        radii[i] = distances[i][idx[: k + 1]].max()
    return radii


def compute_metric(manifold_ref: Manifold, feats_subject: np.ndarray) -> float:
    """The fraction of subject points strictly inside some reference ball
    (`:239-245`)."""
    dist = compute_pairwise_distances(manifold_ref.features, feats_subject)
    inside = (dist < manifold_ref.radii[:, None]).any(axis=0)
    return float(inside.mean())


def realism(manifold_real: Manifold, feat_subject: np.ndarray) -> float:
    """The largest radius / distance over the real points (`:256-266`)."""
    dists = np.linalg.norm(manifold_real.features - feat_subject, axis=1)
    eps = 1e-6
    return float(np.max(manifold_real.radii / (dists + eps)))


def pairwise_distances_device(X: torch.Tensor, Y: torch.Tensor = None) -> torch.Tensor:
    """`compute_pairwise_distances` in f64 on X's device."""
    X = X.double()
    Y = X if Y is None else Y.double()
    x2 = torch.sum(X**2, dim=1, keepdim=True)
    y2 = torch.sum(Y**2, dim=1, keepdim=True)
    return torch.sqrt(torch.clamp_min(x2 - 2 * (X @ Y.T) + y2.T, 0.0))


def radii_device(distances: torch.Tensor, k: int = 3) -> torch.Tensor:
    """`distances2radii` on the device: the (k+1)-th smallest of each row."""
    return torch.topk(distances, k + 1, dim=1, largest=False).values[:, k]


def manifold_device(feats: torch.Tensor, k: int = 3) -> Manifold:
    """The manifold of `feats` (f64 on their device)."""
    feats = feats.double()
    return Manifold(feats, radii_device(pairwise_distances_device(feats), k))


def compute_metric_device(manifold_ref: Manifold, feats_subject: torch.Tensor) -> float:
    """`compute_metric` on the device, of a manifold of tensors."""
    dist = pairwise_distances_device(manifold_ref.features, feats_subject)
    return float((dist < manifold_ref.radii[:, None]).any(dim=0).double().mean())


def precision_and_recall_device(manifold_ref: Manifold, manifold_subject: Manifold) -> PrecisionAndRecall:
    return PrecisionAndRecall(compute_metric_device(manifold_ref, manifold_subject.features),
                              compute_metric_device(manifold_subject, manifold_ref.features))


class IPR:
    """The reference's IPR class (`precision_recall.py:34-110`) on `device`:
    VGG16 fc2 features in batches of `batch_size` (uint8 images are
    dequantized to [-1, 1] on the device), manifolds and metrics on the
    device in f64.  `params` defaults to `default_vgg16_params()`."""

    def __init__(self, batch_size: int = 50, k: int = 3, num_samples: int = 10000, params=None, device="cuda"):
        self.batch_size = batch_size
        self.k = k
        self.num_samples = num_samples
        self.device = torch.empty(0, device=device).device
        self.vgg = vgg16_from_params(params if params is not None else default_vgg16_params(), device=self.device)
        self.manifold_ref = None

    def extract_features(self, images) -> torch.Tensor:
        """fc2 features (n, 4096), f64 on the device, of NCHW images (numpy
        or a tensor) in [-1, 1], or uint8 pixels."""
        u8 = _is_uint8(images)
        feats = []
        with torch.inference_mode():
            for s in range(0, images.shape[0], self.batch_size):
                chunk = torch.as_tensor(images[s : s + self.batch_size]).to(self.device)
                x = chunk.float() / 127.5 - 1.0 if u8 else chunk.float()
                feats.append(vgg16_fc2_features(self.vgg, x).double())
        return torch.cat(feats)

    def compute_manifold(self, images) -> Manifold:
        return manifold_device(self.extract_features(images), self.k)

    def compute_manifold_ref(self, images) -> None:
        self.manifold_ref = self.compute_manifold(images)

    def precision_and_recall(self, subject) -> PrecisionAndRecall:
        if self.manifold_ref is None:
            raise RuntimeError("call compute_manifold_ref() first")
        return precision_and_recall_device(self.manifold_ref, self.compute_manifold(subject))

    __call__ = precision_and_recall

    def realism(self, image) -> float:
        """`realism` of the first image against the reference manifold."""
        feat = self.extract_features(image)[0]
        dists = torch.linalg.norm(self.manifold_ref.features - feat, dim=1)
        return float(torch.max(self.manifold_ref.radii / (dists + 1e-6)))
