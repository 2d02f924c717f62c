"""The evaluation cell: the recipe's in-loop FID, as the port's train CLI
calls it, `Evaluator.compute_inception_score(g_ema)`, back to back.

Set-up draws G's and Inception's weights and the real set from the seed,
builds the evaluator as the CLI builds it (the real set's statistics once,
at its batch), and warms up one chunk of generation and Inception at the
evaluation's batch and one Fréchet distance.  The window starts evaluations
while fewer than `--seconds` have passed; each ends in the host's read of
its FID.

The check takes one evaluation of the window, drawn from the seed, and
holds its FID and the mean and covariance of its activations to the
reference's, which draws the same samples again and runs the plain
generator and InceptionV3 (`benchmark/reference/fid.py`).
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness, inputs, spec
from benchmark import trace as btrace
from benchmark.harness import Window
from benchmark.reference import fid as ref_fid
from benchmark.reference.inception import InceptionPool3


def setup(ctx):
    from rick_tpu_torch.metrics import Evaluator
    from rick_tpu_torch.ops import _build

    cfg, t, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    harness.tf32(False)  # as the train CLI
    if dev == "cuda":
        _build.lib()
    gw, _ = inputs.gan_weights(cfg, seed, dev, ctx.root)
    rng = torch.Generator(device=dev).manual_seed(0)  # the constructor's draws are overwritten below
    g_ema, gcfg = spec.program_models(cfg, ctx.root).generator(cfg, dev, rng)
    g_ema.eval().load_state_dict(gw)
    reals = inputs.images(t["real_samples"], cfg["size"], seed, inputs.IMAGES, dev)
    ev = Evaluator(gcfg, fid_real_samples=reals, inception_nsamples=t["inception_nsamples"],
                   batch_size=t["real_batch"], n_sample_store=t["n_sample_store"], latent=cfg["style_dim"],
                   inception_params=inputs.inception_weights(seed, dev), gen_batch=t["gen_batch"], seed=seed,
                   device=dev, **{f"inception_{k}": v for k, v in _cut(t).items()})
    # warm-up: one chunk at the evaluation's batch, one Fréchet distance
    warm = torch.Generator(device=dev).manual_seed(inputs.stream_seed(seed, inputs.PICK))
    z = torch.randn((ev.gen_batch, ev.latent), generator=warm, device=dev)
    acts = ev.activations(g_ema, z, noise=g_ema.layer_noise(ev.gen_batch, warm, None)).double()
    mu = acts.mean(dim=0)
    ev.fid(mu.float(), ((acts - mu).T @ (acts - mu) / (acts.shape[0] - 1)).float())
    del reals
    return SimpleNamespace(ev=ev, g_ema=g_ema, dev=dev, evals=[])


def window(ctx, prog, seconds: float) -> Window:
    """Evaluations started while fewer than `seconds` have passed; with
    tracing, one more after the window, under the profiler."""
    failed = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        score = prog.ev.compute_inception_score(prog.g_ema)
        failed += not math.isfinite(score["fid"])
        mu, cov = prog.ev.last_stats
        prog.evals.append((score["fid"], mu, cov))
    n = len(prog.evals)
    win = Window(seconds=time.perf_counter() - t_start, units=n, failed=failed, work={"evaluation": n},
                 extra={"fids": [e[0] for e in prog.evals]})
    if ctx.trace and prog.dev == "cuda":
        win.capture, log = btrace.Capture(), btrace.LaunchLog()
        with btrace.captured(win.capture), log.recording():
            prog.ev.compute_inception_score(prog.g_ema)
        win.launches, win.traced_work = log.calls, {"evaluation": 1}
    return win


def end_to_end(win: Window) -> dict:
    return {"fid5k_s": win.seconds / win.units}


def pick(seed: int, n: int) -> int:
    """The evaluation of the window the check takes, drawn from the seed."""
    return int(np.random.default_rng(inputs.stream_seed(seed, inputs.PICK)).integers(n))


def observe(ctx, prog, win: Window) -> dict:
    k = pick(ctx.seed, len(prog.evals))
    fid, mu, cov = prog.evals[k]
    return {"call": k + 1, "fid": fid, "mu": mu.double().cpu(), "cov": cov.double().cpu()}


def reference(ctx, obs, tf32: bool = False) -> dict:
    """The reference's FID, mean and covariance of evaluation `obs["call"]`."""
    cfg, t, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    harness.tf32(tf32)
    try:
        gw, _ = inputs.gan_weights(cfg, seed, dev, ctx.root)
        g, _ = spec.reference_models(cfg, ctx.root).models(cfg, dev)
        g.load_state_dict(gw)
        inception = InceptionPool3(inputs.inception_weights(seed, dev), **_cut(t))
        fake = ref_fid.fake_acts(g, inception, seed=seed, call=obs["call"], n=t["inception_nsamples"],
                                 block=_block(t), device=dev)
        real = ref_fid.real_acts(inception, inputs.images(t["real_samples"], cfg["size"], seed, inputs.IMAGES, dev),
                                 t["ref_batch"])
        mu, cov = ref_fid.stats64(fake)
        real_mu, real_cov = ref_fid.stats64(real)
        return {"call": obs["call"], "fid": ref_fid.frechet64(real_mu, real_cov, mu, cov), "mu": mu.cpu(),
                "cov": cov.cpu()}
    finally:
        harness.tf32(False)


def _cut(t: dict) -> dict:
    """Inception cut short and fed smaller images: set only by the tests'
    own traffic files, which run the cell on the CPU; no cell of
    `BENCHMARK.json` sets it."""
    return {k: t[f"inception_{k}"] for k in ("stop_at", "resize_to") if f"inception_{k}" in t}


def _block(t: dict) -> int:
    """The evaluator's block of draws: the largest divisor of the sample
    count up to `gen_batch`."""
    b = min(t["gen_batch"], t["inception_nsamples"])
    while t["inception_nsamples"] % b:
        b -= 1
    return b


def compare(obs: dict, ref: dict) -> dict:
    """fid_gap: |FID - the reference's| / the reference's; mu_gap and
    cov_gap: the distance of the activations' mean and covariance from the
    reference's, over the reference's norm."""
    return {
        "fid_gap": abs(obs["fid"] - ref["fid"]) / abs(ref["fid"]),
        "mu_gap": float((obs["mu"] - ref["mu"]).norm() / ref["mu"].norm()),
        "cov_gap": float((obs["cov"] - ref["cov"]).norm() / ref["cov"].norm()),
    }
