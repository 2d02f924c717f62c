"""The training cells: the recipe's loop past its warm-up, as the port's
train CLI (`rick_tpu_torch/cli/train.py::main`) runs it, without evaluation,
sample grids or checkpoints.

Set-up builds one training state from the seed's weights, stages the seed's
few-shot set, written as the port's record store, through the CLI's loader
(`open_dataset`, `device_data_stream`), and drives the state through
`warmup_steps` iterations of the schedule from `start_iter`, with the Fisher
round that falls among them: at 400 the round comes first and the first
iteration holds every phase kind (D, R1, G, path).  What those steps
produced is kept (`first_steps`): the round's masks, the first iteration's D
loss, D's whole gradient at its first step and the gradient of each leaf's
last step in the first iteration as norms per filter (Adam's first moment,
with beta1 0), and each leaf's change after `change_after` iterations.  The
window continues the same state in blocks of `block` iterations, each
holding the Fisher round and the metrics fetch that fall at the recipe's
cadence, until `--seconds` have passed.

The reference follows the same steps from the same weights, draws and
batches (`benchmark/reference/train.py`) through the same `first_steps`.
"""

from __future__ import annotations

import math
import shutil
import statistics
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness, inputs, spec
from benchmark import trace as btrace
from benchmark.harness import Window
from benchmark.reference import train as ref_train


def _seed_inputs(ctx):
    cfg, t, dev = ctx.cfg, ctx.traffic, ctx.device
    gw, dw = inputs.gan_weights(cfg, ctx.seed, dev, ctx.root)
    imgs = inputs.images(t["n_sample_train"], cfg["size"], ctx.seed, inputs.IMAGES, dev)
    fz = torch.randn((t["num_fisher_img"], cfg["style_dim"]), generator=inputs.generator(ctx.seed, inputs.FISHER_LATENTS,
                     dev), device=dev)
    return gw, dw, imgs, fz


def filters(name: str, x: torch.Tensor) -> torch.Tensor:
    """`x` as float64 rows, one per filter of a maskable leaf (along the axis
    its masks index: 1 of G's 5-D conv weight, else 0), one row for any
    other leaf."""
    x = x.detach().double()
    if not ref_train.maskable(name):
        return x.reshape(1, -1)
    axis = 1 if x.ndim == 5 else 0
    return x.movedim(axis, 0).reshape(x.shape[axis], -1)


def per_filter(name: str, x: torch.Tensor):
    """The sum of squares of `x` per filter (`filters`), on the host."""
    return filters(name, x).square().sum(dim=1).cpu().numpy()


def fisher_due(t: dict, i: int) -> bool:
    return i >= t["warmup_iter"] and (i - t["warmup_iter"]) % t["fisher_freq"] == 0


def _staged_loader(imgs: torch.Tensor, t: dict, seed: int, device):
    """The few-shot set written as the port's record store under TMPDIR and
    opened as the CLI opens it; the loader stages it whole on the device."""
    from rick_tpu_torch.cli.train import open_dataset
    from rick_tpu_torch.data import RecordStoreWriter, device_data_stream, encode_png

    root = tempfile.mkdtemp(prefix="bench_store_")
    try:
        with RecordStoreWriter(root) as w:
            for img in imgs.permute(0, 2, 3, 1).cpu().numpy():
                w.append(encode_png(img))
        ds = open_dataset(root, imgs.shape[-1])
        loader = device_data_stream(ds, t["batch"], seed=seed, device=device)
        ds.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return loader


def setup(ctx):
    from rick_tpu_torch.cli.train import FISHER_TAG, PHASES_TAG, iteration_generator
    from rick_tpu_torch.ops import _build
    from rick_tpu_torch.train import TrainConfig, fisher_round, init_train_state, merge_prune, run_iteration

    cfg, t, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    harness.tf32(False)  # as the train CLI
    if dev == "cuda":
        _build.lib()
    gw, dw, imgs, fisher_z = _seed_inputs(ctx)
    loader = _staged_loader(imgs, t, seed, dev)
    tcfg = TrainConfig(
        batch=t["batch"], r1=t["r1"], path_regularize=t["path_regularize"], path_batch_shrink=t["path_batch_shrink"],
        d_reg_every=t["d_reg_every"], g_reg_every=t["g_reg_every"], mixing=t["mixing"], lr=t["lr"], augment=False,
        warmup_iter=t["warmup_iter"], fisher_freq=t["fisher_freq"], num_fisher_img=t["num_fisher_img"],
        fisher_quantile=t["fisher_quantile"], prune_quantile=t["prune_quantile"], ema_kimg=t["ema_kimg"])
    rng = torch.Generator(device=dev).manual_seed(0)  # the constructors' draws are overwritten below
    models = spec.program_models(cfg, ctx.root)
    g, gcfg = models.generator(cfg, dev, rng)
    d, dcfg = models.discriminator(cfg, dev, rng)
    g.load_state_dict(gw)
    d.load_state_dict(dw)
    state = init_train_state(gcfg, dcfg, tcfg, rng=rng, device=dev, g=g, d=d)

    def fisher(i):
        reals = torch.cat([next(loader)[:1] for _ in range(t["num_fisher_img"])])
        gf, gp, df, dp = fisher_round(
            state.g_ema, state.d_ema, fisher_z, reals, batch=t["batch"], fisher_quantile=t["fisher_quantile"],
            prune_quantile=t["prune_quantile"], denom=float(t["num_fisher_img"] * t["batch"]),
            gen=iteration_generator(dev, seed, i, FISHER_TAG))
        state.g_freeze, state.d_freeze = gf, df
        if i == t["warmup_iter"]:
            state.g_prune, state.d_prune = gp, dp
        else:
            state.g_prune, state.d_prune = merge_prune(state.g_prune, gp), merge_prune(state.d_prune, dp)

    def step(real, i):
        return run_iteration(state, tcfg, real, i, gen=iteration_generator(dev, seed, i, PHASES_TAG))

    def masks():
        return {"g_freeze": state.g_freeze, "g_prune": state.g_prune, "d_freeze": state.d_freeze,
                "d_prune": state.d_prune}

    def grads():
        return {side: {name: opt.state[p]["exp_avg"] for name, p in module.named_parameters() if p in opt.state}
                for side, module, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt))}

    obs = first_steps(t, fisher, lambda i: step(next(loader), i), masks, grads,
                      (("g", state.g, gw), ("d", state.d, dw), ("g_ema", state.g_ema, gw), ("d_ema", state.d_ema, dw)),
                      state.d_opt)
    del gw, dw
    return SimpleNamespace(state=state, loader=loader, fisher=fisher, step=step,
                           next_i=t["start_iter"] + t["warmup_steps"], obs=obs, dev=dev)


def first_steps(t: dict, fisher, step, masks, grads, modules, d_opt: torch.optim.Optimizer) -> dict:
    """Drive the schedule's first `warmup_steps` iterations from `start_iter`
    and keep what they produced: the first Fisher round's masks, the first
    iteration's D loss, D's whole gradient at its first step (the D phase's,
    which no update precedes, read by a hook on `d_opt`), each leaf's
    gradient at its last step in the first iteration as norms per filter,
    and each leaf's change after `change_after` iterations.  `fisher(i)` runs
    a round, `step(i)` an iteration; `masks()` and `grads()` read the state
    after them; `modules` is (side, module, the weights it started from) for
    G, D and their EMAs; `d_opt` is D's optimizer.
    The program's set-up and the reference both drive their steps here."""
    obs: dict = {}

    def keep_d_grads(*_) -> None:  # after D's first Adam step, the D phase's
        if "d_grads" not in obs:
            obs["d_grads"] = {f"d.{name}": v.detach().to("cpu", torch.float32, copy=True)
                              for name, v in grads()["d"].items()}

    for n in range(t["warmup_steps"]):
        i = t["start_iter"] + n
        if fisher_due(t, i):
            fisher(i)
            obs.setdefault("masks", {f"{side}.{k}": v.detach().to("cpu", copy=True) for side, m in masks().items()
                                     for k, v in m.items()})
        if n == 0:
            hook = d_opt.register_step_post_hook(keep_d_grads)
        metrics = step(i)
        if n == 0:
            hook.remove()
            obs["d_loss"] = float(metrics["d"])
            obs["grads"] = {f"{side}.{name}": per_filter(name, v) for side, leaves in grads().items()
                            for name, v in leaves.items()}
        if n + 1 == t["change_after"]:
            obs["changes"] = {f"{side}.{name}": per_filter(name, p.detach() - w0[name])
                              for side, module, w0 in modules for name, p in module.named_parameters()}
    if "masks" not in obs:
        raise ValueError("the first steps hold no Fisher round")
    return obs


def _phases(t: dict, i: int) -> dict:
    return {"d": 1, "g": 1, "r1": int(i % t["d_reg_every"] == 0),
            "path": int(i % t["g_reg_every"] == 0 and i >= t["warmup_iter"]),
            "fisher_round": int(fisher_due(t, i)), "iteration": 1}


def _work(t: dict, first: int, last: int) -> dict:
    work: dict = {}
    for i in range(first, last + 1):
        for k, v in _phases(t, i).items():
            work[k] = work.get(k, 0) + v
    return work


def window(ctx, prog, seconds: float) -> Window:
    """Blocks of the schedule until `seconds` have passed, the same with or
    without tracing.  A traced run then times one Fisher round alone,
    synchronized at both ends, and runs one more block under the profiler;
    their spans are kept apart from the window's."""
    t = ctx.traffic
    failed = 0

    def block(i0: int, spans: dict, span=btrace.no_span) -> None:
        nonlocal failed
        for i in range(i0, i0 + t["block"]):
            if fisher_due(t, i):
                with span("fisher_round"):
                    prog.fisher(i)
            t0 = time.perf_counter()
            with span("next_batch"):
                real = next(prog.loader)
            spans["data_wait"].append(time.perf_counter() - t0)
            with span("run_iteration"):
                metrics = prog.step(real, i)
            if i % t["log_every"] == 0:  # the CLI's logging fetch
                if not all(math.isfinite(float(v)) for v in metrics.values()):
                    failed += 1

    spans = {"data_wait": [], "fisher": []}
    i = prog.next_i
    t_start = time.perf_counter()
    while True:
        block(i, spans)
        i += t["block"]
        if time.perf_counter() - t_start >= seconds:
            break
    if prog.dev == "cuda":
        torch.cuda.synchronize()
    win = Window(seconds=time.perf_counter() - t_start, units=i - prog.next_i, failed=failed, spans=spans,
                 work=_work(t, prog.next_i, i - 1), extra={"first_iter": prog.next_i, "last_iter": i - 1})
    if ctx.trace and prog.dev == "cuda":
        due = next(j for j in range(i, i + t["fisher_freq"]) if fisher_due(t, j))
        t0 = time.perf_counter()
        prog.fisher(due)
        torch.cuda.synchronize()
        win.spans["fisher"].append(time.perf_counter() - t0)
        win.capture, log = btrace.Capture(), btrace.LaunchLog()
        with btrace.captured(win.capture), log.recording():
            block(i, {"data_wait": []}, btrace.span)
        win.launches, win.traced_work = log.calls, _work(t, i, i + t["block"] - 1)
    return win


def end_to_end(win: Window) -> dict:
    return {"train_iter_ms": win.seconds / win.units * 1e3}


def observe(ctx, prog, win: Window) -> dict:
    return prog.obs


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------


def reference(ctx, obs=None, tf32: bool = False) -> dict:
    """The reference's observations of the same first steps."""
    cfg, t, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    harness.tf32(tf32)
    try:
        gw, dw, imgs, fisher_z = _seed_inputs(ctx)
        g, d = spec.reference_models(cfg, ctx.root).models(cfg, dev)
        g.load_state_dict(gw)
        d.load_state_dict(dw)
        tr = ref_train.Trainer(g, d, t, seed, dev)
        batches = ref_train.StagedBatches(imgs, t["batch"], seed, dev)

        def fisher(i):
            reals = torch.cat([next(batches)[:1] for _ in range(t["num_fisher_img"])])
            tr.fisher_round(fisher_z, reals, i, first=i == t["warmup_iter"])

        out = first_steps(
            t, fisher, lambda i: tr.iteration(next(batches), i),
            lambda: {"g_freeze": tr.g_freeze, "g_prune": tr.g_prune, "d_freeze": tr.d_freeze, "d_prune": tr.d_prune},
            lambda: {"g": ref_train.first_grads(tr.g_opt, tr.g_params), "d": ref_train.first_grads(tr.d_opt, tr.d_params)},
            (("g", tr.g, gw), ("d", tr.d, dw), ("g_ema", tr.g_ema, gw), ("d_ema", tr.d_ema, dw)), tr.d_opt)
        out["numel"] = {f"{side}.{n}": p.numel() for side, module in (("g", tr.g), ("d", tr.d))
                        for n, p in module.named_parameters()}
        return out
    finally:
        harness.tf32(False)


POOLED = "one-element leaves"


def _kept(key: str, n: int, masks_a: dict, masks_b: dict) -> np.ndarray:
    """Which of leaf `key`'s `n` filters both sides train alike: a filter
    frozen on one side only, or pruned on either (its weights set to zero),
    is left out; `mask_flips` counts those."""
    side, leaf = key.split(".", 1)
    model = side.split("_")[0]
    if f"{model}_freeze.{leaf}" not in masks_b:
        return np.ones(n, bool)
    fa, fb = (masks[f"{model}_freeze.{leaf}"].numpy() for masks in (masks_a, masks_b))
    pa, pb = (masks[f"{model}_prune.{leaf}"].numpy() for masks in (masks_a, masks_b))
    return (fa == fb) & (pa == 0) & (pb == 0)


def _norms(a: dict, b: dict, masks_a: dict, masks_b: dict):
    """Each leaf's norm on both sides over the filters both train alike."""
    na, nb = {}, {}
    for key, vb in b.items():
        keep = _kept(key, len(vb), masks_a, masks_b)
        na[key], nb[key] = math.sqrt(a[key][keep].sum()), math.sqrt(vb[keep].sum())
    return na, nb


def _d_grad_gap(a: dict, b: dict, masks_a: dict, masks_b: dict) -> float:
    """D's first gradient by the worst leaf: the larger of |norm_a - norm_b|
    and |<a, b> / norm_b - norm_b| (a's length along b, which a scaled or
    negated gradient moves and noise across b hardly does), over the larger
    of norm_b and the median leaf's norm_b; over the filters both sides
    train alike, leaving out leaves whose norm_b is under a thousandth of
    the median leaf's."""
    na, nb, along = {}, {}, {}
    for key, vb in b.items():
        leaf = key.split(".", 1)[1]
        fa, fb = filters(leaf, a[key]), filters(leaf, vb)
        keep = torch.from_numpy(_kept(key, fb.shape[0], masks_a, masks_b))
        fa, fb = fa[keep], fb[keep]
        na[key], nb[key] = float(fa.norm()), float(fb.norm())
        along[key] = float((fa * fb).sum()) / nb[key] if nb[key] > 0 else 0.0
    med = statistics.median([v for v in nb.values() if v > 0] or [0.0])
    keys = [k for k in nb if nb[k] >= 1e-3 * med and nb[k] > 0]
    if not keys:
        return math.inf
    return max(max(abs(na[k] - nb[k]), abs(along[k] - nb[k])) / max(nb[k], med) for k in keys)


def _pooled(norms: dict, numel: dict) -> dict:
    """The norms with each model's one-element leaves (G's noise weights,
    D's last bias) taken as one vector: alone, each is one sum that cancels
    over its layer and moves by percents with the rounding."""
    out: dict = {}
    for k, v in norms.items():
        side, leaf = k.split(".", 1)
        if numel[f"{side.split('_')[0]}.{leaf}"] == 1:
            key = f"{side}.{POOLED}"
            out[key] = math.hypot(out.get(key, 0.0), v)
        else:
            out[k] = v
    return out


def _leaf_gap(a: dict, b: dict, keys) -> float:
    """The worst leaf's |norm_a - norm_b| over the larger of norm_b and the
    median leaf's norm_b (of the leaves whose norm is not 0)."""
    keys = list(keys)
    nonzero = [b[k] for k in keys if b[k] > 0]
    if not nonzero:
        return max((abs(a[k] - b[k]) for k in keys), default=0.0)
    med = statistics.median(nonzero)
    return max(abs(a[k] - b[k]) / max(b[k], med) for k in keys)


def compare(obs: dict, ref: dict) -> dict:
    """The numbers `correct` holds to their limits:

    d_loss_gap  the first iteration's D loss, which no update precedes,
                relative to the reference's
    d_grad_gap  D's gradient at its first step (the first iteration's D
                phase, which no update precedes), by the worst leaf, in norm
                and in its length along the reference's (`_d_grad_gap`);
                not R1's, later in the iteration: it follows D's first
                update and pruning, whose masks two runs of either side on
                one seed may draw apart, and then reads as far as the faults
                do
    change_gap  the norm of each leaf's change after `change_after`
                iterations, by the worst leaf, leaving out leaves whose
                reference gradient is under a thousandth of the median
                leaf's (they move under Adam by round-off alone); the EMA's
                leaves follow their model's
    mask_flips  the entries of the Fisher round's masks on which the two
                disagree: a coarse number, since two runs of either side on
                one seed already disagree on up to some fifty entries

    Norms are taken over the filters both sides train alike (`_kept`), and
    in `change_gap` a model's one-element leaves count as one leaf
    (`_pooled`).  The first iteration's other losses and G's gradient are
    not compared: past the first update Adam moves every element by its
    step size whatever its gradient's margin, and the path phase
    differentiates G twice through leaky ReLUs whose kink a pre-activation
    within rounding of zero may land on either side of; sound runs read them
    as far from the reference as the control does (PERF.md).  G's gradient
    serves the exclusion rule.
    """
    out = {"d_loss_gap": abs(obs["d_loss"] - ref["d_loss"]) / abs(ref["d_loss"])}
    if (set(obs["grads"]) != set(ref["grads"]) or set(obs["changes"]) != set(ref["changes"])
            or set(obs.get("d_grads", ())) != set(ref["d_grads"])):
        return {**out, "d_grad_gap": math.inf, "change_gap": math.inf, "mask_flips": math.inf}
    gb = _pooled(_norms(obs["grads"], ref["grads"], obs["masks"], ref["masks"])[1], ref["numel"])
    ca, cb = (_pooled(n, ref["numel"]) for n in _norms(obs["changes"], ref["changes"], obs["masks"], ref["masks"]))
    med = statistics.median([v for v in gb.values() if v > 0] or [0.0])

    def counted(name: str) -> bool:
        side, leaf = name.split(".", 1)
        g = gb.get(f"{side.split('_')[0]}.{leaf}")
        return g is None or g >= 1e-3 * med

    return {
        **out,
        "d_grad_gap": _d_grad_gap(obs["d_grads"], ref["d_grads"], obs["masks"], ref["masks"]),
        "change_gap": _leaf_gap(ca, cb, [k for k in cb if counted(k)]),
        "mask_flips": float(sum(int((obs["masks"][k] != v).sum()) for k, v in ref["masks"].items())),
    }
