"""Intra-cluster LPIPS diversity, the reference protocol
(`gan_training/eval.py:83-220`): assign generated samples to K cluster-center
images by least LPIPS, then average the pairwise LPIPS within each cluster
over at most `cluster_size` members.  Port of `rick_tpu/metrics/intra_lpips.py`.

LPIPS of a pair depends only on the two images' normalized VGG taps, so each
image's taps are computed once: the centers' at construction, each sample's
once for the assignment against all K centers, and each member's once for
all its pairs.  `rick_tpu` runs VGG on both inputs of every LPIPS call; the
labels and the pairs are the same, the member shuffle is the same numpy
`Generator`'s, and each distance is the same arithmetic on the same taps.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rick_tpu_torch.data.loader import train_transform
from rick_tpu_torch.data.image import decode_image
from rick_tpu_torch.metrics.lpips import default_lin_weights, lpips_from_normalized, normalize_taps, vgg_taps
from rick_tpu_torch.metrics.vgg import default_vgg16_params, vgg16_from_params
from rick_tpu_torch.utils.images import save_image_grid


def reference_preprocess(imgs, size: int = 256) -> torch.Tensor:
    """The reference's save-as-PNG-and-reload preprocessing
    (`eval.py:96,113-118`): quantize to 8 bits (round half to even, as
    `np.rint`), resize to `size` bilinearly with antialiasing on a
    downscale (PIL's, which `rick_tpu` gets from `jax.image.resize`), back to
    [-1, 1].  `imgs`: (N, 3, H, W) in [-1, 1], numpy or a tensor; the result
    is an f32 tensor on the input's device."""
    x = torch.as_tensor(imgs).float()
    x = torch.clamp(torch.round((x + 1.0) * 127.5), 0, 255) / 127.5 - 1.0
    if x.shape[2] != size or x.shape[3] != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=True)
    return x


class IntraLPIPS:
    def __init__(self, cluster_centers, *, cluster_size: int = 50, batch: int = 8, preprocess: bool = True,
                 size: int = 256, vgg_params=None, lin_weights=None, device="cuda"):
        """cluster_centers: (K, 3, H, W) images in [-1, 1].  preprocess=True
        applies `reference_preprocess` to the centers and the samples;
        False compares the tensors as given.  `vgg_params` / `lin_weights`
        default to `default_vgg16_params()` / `default_lin_weights()`.  VGG
        runs on batches of `batch` images, and the pair distances are taken
        `batch` pairs at a time."""
        self.device = torch.empty(0, device=device).device
        self.preprocess = preprocess
        self.size = size
        self.cluster_size = cluster_size
        self.batch = batch
        self.vgg = vgg16_from_params(vgg_params if vgg_params is not None else default_vgg16_params(),
                                     device=self.device)
        self.lin = [torch.as_tensor(w).float().to(self.device)
                    for w in (lin_weights if lin_weights is not None else default_lin_weights())]
        centers = torch.as_tensor(cluster_centers, dtype=torch.float32, device=self.device)
        self.centers = reference_preprocess(centers, size) if preprocess else centers
        with torch.inference_mode():
            self._center_taps = self._taps(self.centers)

    def _taps(self, imgs: torch.Tensor) -> List[torch.Tensor]:
        """The normalized LPIPS taps of `imgs`, VGG in batches of `batch`."""
        parts = [normalize_taps(vgg_taps(self.vgg, imgs[s : s + self.batch]))
                 for s in range(0, imgs.shape[0], self.batch)]
        return [torch.cat(layer) for layer in zip(*parts)]

    def _assign_pre(self, imgs: torch.Tensor) -> np.ndarray:
        """The least-LPIPS center of each (already preprocessed) image."""
        dists = []
        for s in range(0, imgs.shape[0], self.batch):
            taps = normalize_taps(vgg_taps(self.vgg, imgs[s : s + self.batch]))
            dists.append(torch.stack([
                lpips_from_normalized(taps, [c[k : k + 1] for c in self._center_taps], self.lin)
                for k in range(self.centers.shape[0])
            ], dim=1))
        return np.argmin(torch.cat(dists).cpu().numpy(), axis=1)

    def _inputs(self, imgs) -> torch.Tensor:
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        return reference_preprocess(imgs, self.size) if self.preprocess else imgs

    def assign(self, imgs) -> np.ndarray:
        """Cluster index of each image, argmin of LPIPS to the centers
        (`eval.py:123-155`)."""
        with torch.inference_mode():
            return self._assign_pre(self._inputs(imgs))

    def compute(self, imgs, *, rng: Optional[np.random.Generator] = None) -> float:
        """The mean over clusters of the mean pairwise LPIPS of each
        cluster's members, shuffled by `rng` and cut to `cluster_size`
        (`eval.py:158-200`); clusters of fewer than 2 members are left out,
        nan when none is left."""
        rng = rng or np.random.default_rng(0)
        with torch.inference_mode():
            imgs = self._inputs(imgs)
            labels = self._assign_pre(imgs)
            cluster_means: List[float] = []
            for k in range(self.centers.shape[0]):
                members = np.where(labels == k)[0]
                if len(members) < 2:
                    continue
                rng.shuffle(members)
                members = members[: self.cluster_size]
                taps = self._taps(imgs[torch.from_numpy(members).to(self.device)])
                pair_a, pair_b = (torch.from_numpy(p).to(self.device) for p in np.triu_indices(len(members), 1))
                dists = [
                    lpips_from_normalized([t[pair_a[s : s + self.batch]] for t in taps],
                                          [t[pair_b[s : s + self.batch]] for t in taps], self.lin)
                    for s in range(0, len(pair_a), self.batch)
                ]
                cluster_means.append(float(torch.cat(dists).cpu().numpy().mean()))
        return float(np.mean(cluster_means)) if cluster_means else float("nan")


def load_cluster_centers(base_path: str, k: int = 10, size: int = 256) -> np.ndarray:
    """`c{0..k-1}/center.png` under `base_path` as (k, 3, size, size) in
    [-1, 1] (`eval.py:131-138`), through `decode_image` (PNG or JPEG
    content, whatever the name) and the transform."""
    rng = np.random.default_rng(0)
    centers = []
    for i in range(k):
        path = os.path.join(base_path, f"c{i}", "center.png")
        with open(path, "rb") as fh:
            centers.append(train_transform(decode_image(fh.read(), name=path), size, rng, flip=False))
    return np.stack(centers)


def prepare_cluster_centers(images, out_dir: str) -> None:
    """Write the reference's cluster-center layout, `{out_dir}/c{k}/center.png`
    for each of the K images ((K, 3, H, W) in [-1, 1]).  The few-shot
    protocol takes the K target training images themselves as the centers
    (`eval.py:129-131`)."""
    images = torch.as_tensor(images).float()
    for k in range(images.shape[0]):
        d = os.path.join(out_dir, f"c{k}")
        os.makedirs(d, exist_ok=True)
        save_image_grid(images[k : k + 1], os.path.join(d, "center.png"), nrow=1, padding=0)
