"""The in-training evaluator, on one device.  Port of
`rick_tpu/metrics/evaluator.py`.

`inception_nsamples` images from fresh N(0, 1) latents and fresh noise go
through the EMA generator in chunks of `gen_batch`, each chunk straight into
InceptionV3; the pool3 activations stay on the device, and their mean and
covariance (two-pass, f32, ddof 1) give the FID against the real set's,
which are computed once at construction.  The generated images never leave
the device.  KID uses the first 2000 activations of each side.  With
`compute_pr`, precision and recall take VGG16 fc2 features of as many fresh
draws, against the real set's manifold, built once; `compute_intra_lpips`
scores generated samples against a cluster-center directory.

Randomness comes from one `torch.Generator` on the evaluator's device, seeded
with `seed`.  `fast_gen=None` takes the fused upsample kernel (K4) wherever
g_ema is on a CUDA device and the plain chain on the CPU; an explicit bool is
the caller's choice.

Not here: the data-parallel mesh (`mesh=`) and a generation dtype other
than float32 (both raise NotImplementedError, see ROADMAP).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from rick_tpu_torch.metrics.fid import (
    _is_uint8,
    calculate_frechet_distance,
    frechet_distance_device,
    get_activations,
)
from rick_tpu_torch.metrics.inception import default_inception_params, inception_from_params
from rick_tpu_torch.metrics.intra_lpips import IntraLPIPS, load_cluster_centers
from rick_tpu_torch.metrics.precision_recall import IPR, manifold_device, precision_and_recall_device
from rick_tpu_torch.metrics.vgg import vgg16_fc2_features

KID_SUBSETS = 100


def _stats_from_acts(acts: torch.Tensor):
    """(n, d) activations -> (mu, cov), f32, np.cov's ddof=1, two passes."""
    x = acts.float()
    mu = x.mean(dim=0)
    xc = x - mu
    return mu, (xc.T @ xc) / (x.shape[0] - 1)


def kid_subsets(real_acts: torch.Tensor, fake_acts: torch.Tensor, real_idx: torch.Tensor,
                fake_idx: torch.Tensor) -> torch.Tensor:
    """The unbiased MMD^2 with the cubic polynomial kernel k(a, b) =
    (a.b / d + 1)^3 between real_acts[real_idx[s]] and fake_acts[fake_idx[s]]
    for each subset s; (n_subsets,)."""
    d = real_acts.shape[1]
    m = real_idx.shape[1]
    out = []
    for gi, ri in zip(real_idx, fake_idx):
        g, r = real_acts[gi], fake_acts[ri]
        kxx = (g @ g.T / d + 1.0) ** 3
        kyy = (r @ r.T / d + 1.0) ** 3
        kxy = (g @ r.T / d + 1.0) ** 3
        out.append((kxx.sum() - kxx.diagonal().sum() + kyy.sum() - kyy.diagonal().sum()) / (m * (m - 1))
                   - 2.0 * kxy.sum() / (m * m))
    return torch.stack(out)


class Evaluator:
    def __init__(
        self,
        gcfg,
        *,
        fid_real_samples,
        inception_nsamples: int = 5000,
        batch_size: int = 64,
        n_sample_store: int = 25,
        latent: int = 512,
        compute_pr: bool = False,
        inception_params=None,
        gen_batch: int = 100,
        inception_dtype: torch.dtype = torch.float32,
        gen_dtype: torch.dtype = torch.float32,
        inception_nhwc: bool = False,
        real_acts: Optional[np.ndarray] = None,
        seed: int = 0,
        mesh=None,
        fast_gen: Optional[bool] = None,
        inception_stop_at: Optional[str] = None,
        inception_resize_to: int = 299,
        device="cuda",
    ):
        """`fid_real_samples`: the real set, (n, 3, H, W), uint8 pixels or
        floats in [-1, 1] (numpy or a tensor); `real_acts` skips its
        extraction.  `inception_nhwc` runs Inception in channels_last.
        `inception_stop_at` / `inception_resize_to` cut the Inception trunk
        for cheap tests, on both sides alike (metric values use the
        defaults)."""
        if mesh is not None:
            raise NotImplementedError("Evaluator(mesh=...): the sharded eval is ROADMAP queue 1 item 13")
        if gen_dtype != torch.float32:
            raise NotImplementedError(f"gen_dtype {gen_dtype}: generation runs in float32 only (K4 is f32)")
        self.gcfg = gcfg
        self.device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0", as a module reports it
        self._fast = self.device.type == "cuda" if fast_gen is None else bool(fast_gen)
        real = fid_real_samples
        if not _is_uint8(real):  # uint8 stays raw pixels, dequantized on the device
            real = real.float() if isinstance(real, torch.Tensor) else np.asarray(real, np.float32)
        self.real = real
        self.inception_nsamples = inception_nsamples
        self.batch_size = batch_size
        self.n_sample_store = n_sample_store
        self.latent = latent
        # chunk size dividing n evenly
        gen_batch = min(gen_batch, inception_nsamples)
        while inception_nsamples % gen_batch != 0:
            gen_batch -= 1
        self.gen_batch = gen_batch
        self.n_chunks = inception_nsamples // gen_batch
        self.inception = inception_from_params(
            inception_params if inception_params is not None else default_inception_params(),
            device=self.device, dtype=inception_dtype, channels_last=inception_nhwc,
        )
        self._pool3_kw = dict(stop_at=inception_stop_at, resize_to=inception_resize_to)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # VGG16 (default_vgg16_params) for precision/recall; the real manifold is built at the first call
        self.ipr = IPR(batch_size, k=3, num_samples=inception_nsamples, device=self.device) if compute_pr else None

        if real_acts is not None:
            self._real_acts = np.asarray(real_acts, np.float64)
        else:
            self._real_acts = get_activations(self.real, batch_size, self.inception, **self._pool3_kw)
        self._real_acts_dev = torch.as_tensor(self._real_acts, dtype=torch.float32, device=self.device)
        self._real_mu, self._real_cov = _stats_from_acts(self._real_acts_dev)
        self._real_stats64 = None  # f64 real-side stats, for the scipy path
        self.last_stats = None  # (mu, cov) of the last compute_inception_score's draws

    # ------------------------------------------------------------------
    def _check(self, g_ema) -> None:
        if g_ema.device != self.device:
            raise ValueError(f"g_ema is on {g_ema.device}, the evaluator on {self.device}")

    def activations(self, g_ema, z: torch.Tensor, *, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """pool3 activations (n, d), f32 on the device, of g_ema's images of
        the latents `z` (n, latent), in chunks of `gen_batch`; noise is drawn
        from `rng`, or is the generator's constant buffers when `rng` is None."""
        self._check(g_ema)
        out = []
        with torch.inference_mode():
            for zc in z.split(self.gen_batch):
                imgs, _ = g_ema([zc], rng=rng, fast=self._fast)
                out.append(self.inception.pool3(imgs, **self._pool3_kw).float())
        return torch.cat(out)

    def vgg_features(self, g_ema, z: torch.Tensor, *, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """VGG16 fc2 features (n, 4096), f64 on the device, of g_ema's images
        of the latents `z`, in chunks of `gen_batch`; noise as in
        `activations`."""
        self._check(g_ema)
        out = []
        with torch.inference_mode():
            for zc in z.split(self.gen_batch):
                imgs, _ = g_ema([zc], rng=rng, fast=self._fast)
                out.append(vgg16_fc2_features(self.ipr.vgg, imgs).double())
        return torch.cat(out)

    def _fake_acts(self, g_ema) -> torch.Tensor:
        """The activations of `inception_nsamples` fresh draws."""
        out = []
        for _ in range(self.n_chunks):
            z = torch.randn((self.gen_batch, self.latent), generator=self._gen, device=self.device)
            out.append(self.activations(g_ema, z, rng=self._gen))
        return torch.cat(out)

    def real_stats64(self):
        """The real set's (mu, cov) in f64 on the host."""
        if self._real_stats64 is None:
            acts64 = self._real_acts
            mu64 = acts64.mean(axis=0)
            xc = acts64 - mu64
            self._real_stats64 = (mu64, xc.T @ xc / (acts64.shape[0] - 1))
        return self._real_stats64

    def fid(self, mu: torch.Tensor, cov: torch.Tensor) -> float:
        """The FID of (mu, cov) against the real set: on the device in f32, or
        with RICK_FID_HOST_SQRTM=1 by scipy against f64 real-side stats."""
        if os.environ.get("RICK_FID_HOST_SQRTM"):
            return calculate_frechet_distance(
                *self.real_stats64(), mu.double().cpu().numpy(), cov.double().cpu().numpy(),
            )
        return frechet_distance_device(self._real_mu, self._real_cov, mu, cov)

    def _generate(self, g_ema, n: int) -> torch.Tensor:
        """n generated images on the device, in chunks of `n_sample_store`."""
        self._check(g_ema)
        outs, got = [], 0
        with torch.inference_mode():
            while got < n:
                z = torch.randn((self.n_sample_store, self.latent), generator=self._gen, device=self.device)
                imgs, _ = g_ema([z], rng=self._gen, fast=self._fast)
                outs.append(imgs.float())
                got += imgs.shape[0]
        return torch.cat(outs)[:n]

    def generate(self, g_ema, n: Optional[int] = None) -> torch.Tensor:
        """n generated images (default `inception_nsamples`), f32 on the
        host, in chunks of `n_sample_store` (sample grids, interop)."""
        return self._generate(g_ema, n or self.inception_nsamples).cpu()

    def compute_inception_score(self, g_ema, *, fid: bool = True, kid: bool = False,
                                pr: bool = False) -> Dict[str, float]:
        if pr and self.ipr is None:
            raise ValueError("pr=True needs an Evaluator built with compute_pr=True")
        score: Dict[str, float] = {}
        acts = self._fake_acts(g_ema)
        mu, cov = _stats_from_acts(acts)
        self.last_stats = (mu, cov)
        if kid:
            real, fake = self._real_acts_dev[:2000], acts[:2000]
            m = min(1000, real.shape[0], fake.shape[0])

            def draw(n):
                return torch.stack([torch.randperm(n, generator=self._gen, device=self.device)[:m]
                                    for _ in range(KID_SUBSETS)])

            score["kid"] = float(kid_subsets(real, fake, draw(real.shape[0]), draw(fake.shape[0])).mean())
        if fid:
            score["fid"] = self.fid(mu, cov)
        if pr:
            if self.ipr.manifold_ref is None:  # the real set's, the same at every call
                self.ipr.compute_manifold_ref(self.real)
            feats = torch.cat([
                self.vgg_features(g_ema, torch.randn((self.gen_batch, self.latent), generator=self._gen,
                                                     device=self.device), rng=self._gen)
                for _ in range(self.n_chunks)
            ])
            score["precision"], score["recall"] = precision_and_recall_device(
                self.ipr.manifold_ref, manifold_device(feats, self.ipr.k))
        return score

    def compute_intra_lpips(self, g_ema, cluster_center_path: str, *, n_samples: int = 1000,
                            cluster_size: int = 50, k: int = 10, size: int = 256, seed: int = 0) -> float:
        """Intra-cluster LPIPS diversity (`gan_training/eval.py:83-220`):
        `n_samples` fresh images, each assigned to the nearest of the `k`
        centers under `cluster_center_path` (`c{k}/center.png`, written by
        `intra_lpips.prepare_cluster_centers`) by LPIPS-VGG, then the mean
        pairwise LPIPS within each cluster over at most `cluster_size`
        members, the members shuffled by `np.random.default_rng(seed)`.  The
        reference's PNG round trip and resize (to `size`) are applied to the
        tensors (`intra_lpips.reference_preprocess`)."""
        centers = load_cluster_centers(cluster_center_path, k=k, size=size)
        il = IntraLPIPS(centers, cluster_size=cluster_size, size=size, device=self.device)
        return il.compute(self._generate(g_ema, n_samples), rng=np.random.default_rng(seed))
