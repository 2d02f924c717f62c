"""The in-training evaluator, on one device.  Port of
`rick_tpu/metrics/evaluator.py`.

`inception_nsamples` images from fresh N(0, 1) latents and fresh noise go
through the EMA generator in chunks of `gen_batch`, each chunk straight into
InceptionV3; the pool3 activations stay on the device, and their mean and
covariance (two-pass, f32, ddof 1) give the FID against the real set's,
which are computed once at construction.  The generated images never leave
the device.  KID uses the first 2000 activations of each side.

Randomness comes from one `torch.Generator` on the evaluator's device, seeded
with `seed`.  `fast_gen=None` takes the fused upsample kernel (K4) wherever
g_ema is on a CUDA device and the plain chain on the CPU; an explicit bool is
the caller's choice.

Not here: the data-parallel mesh (`mesh=`), precision/recall and intra-LPIPS
(they raise NotImplementedError, see ROADMAP).
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
        if compute_pr:
            raise NotImplementedError("precision/recall (VGG16) is ROADMAP queue 1 item 12")
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

    def generate(self, g_ema, n: Optional[int] = None) -> torch.Tensor:
        """n generated images (default `inception_nsamples`), f32 on the
        host, in chunks of `n_sample_store` (sample grids, interop)."""
        self._check(g_ema)
        n = n or self.inception_nsamples
        outs, got = [], 0
        with torch.inference_mode():
            while got < n:
                z = torch.randn((self.n_sample_store, self.latent), generator=self._gen, device=self.device)
                imgs, _ = g_ema([z], rng=self._gen, fast=self._fast)
                outs.append(imgs.float().cpu())
                got += imgs.shape[0]
        return torch.cat(outs)[:n]

    def compute_inception_score(self, g_ema, *, fid: bool = True, kid: bool = False,
                                pr: bool = False) -> Dict[str, float]:
        if pr:
            raise NotImplementedError("precision/recall (VGG16) is ROADMAP queue 1 item 12")
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
        return score

    def compute_intra_lpips(self, g_ema, cluster_center_path: str, **kw) -> float:
        raise NotImplementedError("intra-LPIPS (LPIPS-VGG) is ROADMAP queue 1 item 12")
