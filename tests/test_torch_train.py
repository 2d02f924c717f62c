"""The port's training slice against `rick_tpu` on the CPU.

* the autograd Functions of K1/K2 and K3 (`FusedBiasAct`,
  `FusedBiasActBackward`, `ModconvEpilogue`) against `jax.vjp` of the Pallas
  kernels in interpret mode, and their double backward against
  `jax.grad` of `jax.vjp` of the jnp formulations; `gradgradcheck` in float64;
* losses, `path_stats`, `ada_update`, Adam with a warmup offset, the masks;
* each of the four phases and `run_iteration` against `rick_tpu`'s own
  `make_train_step` phases, from the same 16px state (two JAX iterations in,
  so that Adam's second moments are non-zero) with the same draws: JAX's
  draws are recomputed outside its jit from the same key and handed to the
  port.  Compared: losses, post-step params of G, D and the EMA copies,
  Adam's second moments and step counts, the mean path length.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.nn import DiscriminatorConfig as JDCfg
from rick_tpu.nn import GeneratorConfig as JGCfg
from rick_tpu.nn import discriminator_init, generator_init
from rick_tpu.nn.generator import _layer_noise
from rick_tpu.ops.fused_act import fused_leaky_relu as j_fused_leaky_relu
from rick_tpu.ops.pallas_kernels import fused_bias_act_pallas, modconv_epilogue_pallas
from rick_tpu.train import TrainConfig as JTrainConfig
from rick_tpu.train import init_train_state as j_init_train_state
from rick_tpu.train import make_train_step
from rick_tpu.train import run_iteration as j_run_iteration
from rick_tpu.train import adam as j_adam
from rick_tpu.train import losses as j_losses
from rick_tpu.train import masks as j_masks
from rick_tpu.train.steps import _phase_key
from rick_tpu.train.steps import ada_update as j_ada_update
from rick_tpu_torch import ops
from rick_tpu_torch.ckpt import (
    d_masks_from_jax,
    discriminator_state_dict_from_jax,
    g_masks_from_jax,
    generator_state_dict_from_jax,
    train_state_from_jax,
)
from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
from rick_tpu_torch.train import Draws, TrainConfig, losses, run_iteration
from rick_tpu_torch.train import adam as p_adam
from rick_tpu_torch.train import masks as p_masks
from rick_tpu_torch.train import steps as p_steps
from rick_tpu_torch.train.state import trainable_params
from tests.torch_port_helpers import close, j, n, one_torch_thread, perturb_zeros, rand, t  # noqa: F401

SIZE = 16
JG, JD = JGCfg(size=SIZE), JDCfg(size=SIZE)
PG, PD = GeneratorConfig(size=SIZE), DiscriminatorConfig(size=SIZE)
TC = dict(batch=2, augment=False, warmup_iter=1)


def _vjp(f, primals, cot):
    return jax.vjp(f, *primals)[1](cot)


# ---------------------------------------------------------------------------
# K1 / K2 as autograd Functions
# ---------------------------------------------------------------------------

FBA_SHAPES = [(2, 8, 16, 16), (4, 32), (3, 5, 7, 9)]


def _fba_inputs(shape, seed):
    c = shape[-1] if len(shape) == 2 else shape[1]
    return rand(shape, seed), rand((c,), seed + 1), rand(shape, seed + 2)


@pytest.mark.parametrize("shape", FBA_SHAPES)
def test_fused_bias_act_grads_match_pallas_vjp(shape):
    x, b, w = _fba_inputs(shape, 0)
    gx_j, gb_j = _vjp(lambda x, b: fused_bias_act_pallas(x, b, 0.2, 2.0**0.5, True), (j(x), j(b)), j(w))
    xt, bt = t(x).requires_grad_(True), t(b).requires_grad_(True)
    gx, gb = torch.autograd.grad(ops.fused_bias_act(xt, bt), (xt, bt), t(w))
    # gx elementwise, same order: 1e-6; gb a sum over batch and space: 1e-5
    close(gx, gx_j, rtol=1e-6, atol_frac=1e-6)
    close(gb, gb_j, rtol=1e-5, atol_frac=1e-5)


@pytest.mark.parametrize("shape", FBA_SHAPES)
def test_fused_bias_act_double_grads_match_jax(shape):
    """d/dw of <gx, u> + <gb, v>, where (gx, gb) = vjp(w): the second
    derivative that R1 and path length take (d2y/dx2 = 0, so it is the mask
    applied to u + v[c])."""
    x, b, w = _fba_inputs(shape, 10)
    u, v = rand(shape, 13), rand(b.shape, 14)

    def first(w):
        gx, gb = _vjp(lambda x, b: j_fused_leaky_relu(x, b), (j(x), j(b)), w)
        return jnp.sum(gx * j(u)) + jnp.sum(gb * j(v))

    want = jax.grad(first)(j(w))
    xt, bt, wt = (t(a).requires_grad_(True) for a in (x, b, w))
    gx, gb = torch.autograd.grad(ops.fused_bias_act(xt, bt), (xt, bt), wt, create_graph=True)
    got_w, got_x = torch.autograd.grad((gx * t(u)).sum() + (gb * t(v)).sum(), (wt, xt), allow_unused=True)
    close(got_w, want, rtol=1e-6, atol_frac=1e-6)  # elementwise: 1e-6
    assert got_x is None or not got_x.any()


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (3, 6)])
def test_fused_bias_act_gradgradcheck_float64(shape):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    c = shape[-1] if len(shape) == 2 else shape[1]
    b = torch.randn((c,), generator=gen, dtype=torch.float64)
    # keep x + b away from the kink, where the finite differences straddle it
    x = torch.where((x + ops.kernels._bias_view(b, x.ndim)).abs() < 0.1, x + 0.3, x).requires_grad_(True)
    b.requires_grad_(True)
    f = lambda x, b: ops.fused_bias_act(x, b)  # noqa: E731
    assert torch.autograd.gradcheck(f, (x, b))
    assert torch.autograd.gradgradcheck(f, (x, b))


# ---------------------------------------------------------------------------
# K3 as an autograd Function
# ---------------------------------------------------------------------------


def _epi_inputs(shape, noise_batch, seed):
    B, C, H, W = shape
    return (rand(shape, seed), np.abs(rand((B, C), seed + 1)) + 0.1,
            rand((noise_batch, 1, H, W), seed + 2), np.float32(0.7), rand((C,), seed + 3), rand(shape, seed + 4))


def _epi_plain_jax(out, demod, noise, nw, bias):
    v = out * demod[:, :, None, None] + nw * noise + bias.reshape(1, -1, 1, 1)
    return jnp.where(v >= 0, v, v * 0.2) * 2.0**0.5


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (3, 5, 7, 9)])
@pytest.mark.parametrize("noise_batch", ["B", "1"])
def test_modconv_epilogue_grads_match_pallas_vjp(shape, noise_batch):
    B = shape[0]
    out, demod, noise, nw, bias, w = _epi_inputs(shape, B if noise_batch == "B" else 1, 20)
    # the Pallas kernel takes per-sample noise: hand it the broadcast and sum
    # its noise gradient over the batch
    noise_b = np.ascontiguousarray(np.broadcast_to(noise, (B,) + noise.shape[1:]))
    want = _vjp(lambda *a: modconv_epilogue_pallas(*a, 0.2, 2.0**0.5, True),
                (j(out), j(demod), j(noise_b), jnp.float32(nw), j(bias)), j(w))
    want = list(want)
    if noise_batch == "1":
        want[2] = jnp.sum(want[2], axis=0, keepdims=True)
    args = [t(out), t(demod), t(noise), torch.tensor([nw]), t(bias)]
    args = [a.requires_grad_(True) for a in args]
    got = torch.autograd.grad(ops.modconv_epilogue(*args), args, t(w))
    # d_out elementwise: 1e-6; the rest are sums over space or batch: 1e-5
    close(got[0], want[0], rtol=1e-6, atol_frac=1e-6)
    for g_, w_ in zip(got[1:], want[1:]):
        close(g_.reshape(np.shape(w_)), w_, rtol=1e-5, atol_frac=1e-5)


@pytest.mark.parametrize("noise_batch", ["B", "1"])
def test_modconv_epilogue_double_grads_match_jax(noise_batch):
    """Second derivatives of <vjp(w), u> with respect to w, out, demod and
    the noise weight, against jax.grad of jax.vjp of the jnp chain."""
    shape = (2, 6, 5, 5)
    out, demod, noise, nw, bias, w = _epi_inputs(shape, 2 if noise_batch == "B" else 1, 30)
    us = [rand(s, 40 + i) for i, s in enumerate([shape, demod.shape, noise.shape, (), bias.shape])]

    def first(w, out, demod, nw):
        cots = _vjp(_epi_plain_jax, (out, demod, j(noise), nw, j(bias)), w)
        return sum(jnp.sum(c * j(u)) for c, u in zip(cots, us))

    want = jax.grad(first, argnums=(0, 1, 2, 3))(j(w), j(out), j(demod), jnp.float32(nw))
    wt, ot, dt, nt = (a.requires_grad_(True) for a in (t(w), t(out), t(demod), torch.tensor([nw])))
    nz, bt = t(noise).requires_grad_(True), t(bias).requires_grad_(True)
    cots = torch.autograd.grad(ops.modconv_epilogue(ot, dt, nz, nt, bt), (ot, dt, nz, nt, bt), wt, create_graph=True)
    loss = sum((c.reshape(u.shape) * t(u)).sum() for c, u in zip(cots, us))
    got = torch.autograd.grad(loss, (wt, ot, dt, nt))
    # products and sums of a few terms per element: 1e-5
    for g_, w_ in zip(got, want):
        close(g_.reshape(np.shape(w_)), w_, rtol=1e-5, atol_frac=1e-5)


@pytest.mark.parametrize("noise_batch", [2, 1])
def test_modconv_epilogue_gradgradcheck_float64(noise_batch):
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64)  # noqa: E731
    out, demod, noise, nw, bias = r(2, 3, 4, 4), r(2, 3).abs() + 0.5, r(noise_batch, 1, 4, 4), r(1), r(3)
    pre = out * demod[:, :, None, None] + nw * noise + bias.reshape(1, -1, 1, 1)
    out = torch.where(pre.abs() < 0.1, out + 0.3 / demod[:, :, None, None], out)  # off the kink
    args = tuple(a.requires_grad_(True) for a in (out, demod, noise, nw, bias))
    assert torch.autograd.gradcheck(ops.modconv_epilogue, args)
    assert torch.autograd.gradgradcheck(ops.modconv_epilogue, args)


# ---------------------------------------------------------------------------
# losses, ADA, Adam, masks
# ---------------------------------------------------------------------------


def test_losses_and_path_stats_match_jax():
    real, fake = rand((4, 1), 0, 3.0), rand((4, 1), 1, 3.0)
    close(losses.d_logistic_loss(t(real), t(fake)), j_losses.d_logistic_loss(j(real), j(fake)), rtol=1e-6, atol_frac=0)
    close(losses.g_nonsaturating_loss(t(fake)), j_losses.g_nonsaturating_loss(j(fake)), rtol=1e-6, atol_frac=0)
    grad, mpl = rand((3, 6, 16), 2), np.float32(0.8)
    want = j_losses.path_stats(j(grad), jnp.float32(mpl))
    gt = t(grad).requires_grad_(True)
    got = losses.path_stats(gt, torch.tensor(mpl))
    for a, b in zip(got, want):
        close(a, b, rtol=1e-6, atol_frac=1e-6)
    assert not got[1].requires_grad
    # the penalty's gradient runs through the new mean too, as in JAX
    want_g = jax.grad(lambda g: j_losses.path_stats(g, jnp.float32(mpl))[0])(j(grad))
    close(torch.autograd.grad(got[0], gt)[0], want_g, rtol=1e-5, atol_frac=1e-6)


@pytest.mark.parametrize("n_pred,sign", [(100, 1.0), (300, 1.0), (300, -1.0)])
def test_ada_update_matches_jax(n_pred, sign):
    tc = dict(ada_target=0.6, ada_length=1000)
    pred = sign * np.abs(rand((n_pred, 1), n_pred))
    pred[:7] *= -1
    state = (np.float32(0.5), np.asarray([10.0, 20.0], np.float32), np.float32(0.1))
    want = j_ada_update(*map(jnp.asarray, state), j(pred), JTrainConfig(**tc))
    got = p_steps.ada_update(*map(torch.tensor, state), t(pred), TrainConfig(**tc))
    for a, b in zip(got, want):
        close(a, b, rtol=1e-6, atol_frac=0)


def test_adam_with_warmup_offset_matches_jax():
    """'b' is inactive for three steps (as D's non-final params in warmup):
    its count must not advance and its value must not move."""
    beta2, lr = 0.99 ** (16 / 17), 0.002 * 16 / 17
    a0, b0 = rand((5,), 0), rand((4, 3), 1)
    params = {"a": torch.nn.Parameter(t(a0)), "b": torch.nn.Parameter(t(b0))}
    opt = p_adam.make_adam(params, lr=lr, beta2=beta2)
    jp = {"a": j(a0), "b": j(b0)}
    js = j_adam.adam_init(jp)
    for step in range(6):
        ga, gb = rand((5,), 10 + step), rand((4, 3), 20 + step)
        warm = step < 3
        p_adam.adam_step(opt, params, {"a": t(ga)} if warm else {"a": t(ga), "b": t(gb)})
        active = {"a": jnp.asarray(1.0), "b": jnp.asarray(0.0 if warm else 1.0)}
        jp, js = j_adam.adam_update(jp, {"a": j(ga), "b": j(gb * (not warm))}, js, active, lr=lr, beta2=beta2)
        assert p_adam.step_counts(opt, params) == {"a": step + 1, "b": max(0, step - 2)}
    for k in params:
        close(params[k], jp[k], rtol=1e-5, atol_frac=1e-6)
        close(p_adam.exp_avg_sq(opt, params)[k], js["v"][k], rtol=1e-5, atol_frac=1e-6)


def _jax_params():
    g = perturb_zeros(generator_init(jax.random.key(0), JG), 100)
    d = perturb_zeros(discriminator_init(jax.random.key(1), JD), 200)
    return g, d


def _random_masks(masks, seed):
    leaves, tree = jax.tree_util.tree_flatten(masks)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray((rng.random(x.shape) < 0.3).astype(np.float32)) for x in leaves])


def test_masks_and_trainable_sets_match_jax(jax_train):
    _, _, state_np = jax_train
    g_np, d_np = state_np["g"], state_np["d"]
    port = train_state_from_jax(PG, PD, state_np, tcfg=TrainConfig(**TC), device="cpu")
    g, d = port.g, port.d
    gsd = lambda tree: generator_state_dict_from_jax(JG, tree)  # noqa: E731
    dsd = lambda tree: discriminator_state_dict_from_jax(JD, tree)  # noqa: E731
    # init masks: same names and sizes
    for got, want in ((p_masks.init_g_masks(g), g_masks_from_jax(j_masks.init_g_masks(g_np))),
                      (p_masks.init_d_masks(d), d_masks_from_jax(j_masks.init_d_masks(d_np)))):
        assert got.keys() == want.keys()
        assert all(got[k].shape == want[k].shape and not got[k].any() for k in got)
    # trainable / warmup sets
    for pred, tree, sd, module in ((p_masks.g_trainable, j_masks.g_trainable_tree(g_np), gsd, g),
                                   (p_masks.d_trainable, j_masks.d_trainable_tree(d_np), dsd, d),
                                   (p_masks.d_final, j_masks.d_final_tree(d_np), dsd, d)):
        flags = sd(jax.tree.map(np.float32, tree))
        for name, _ in module.named_parameters():
            assert pred(name) == bool(flags[name].reshape(-1)[0]), name
    # grads masked and params pruned
    for (jmask, jprune, conv, masks_from, module, jparams, seed) in (
        (j_masks.mask_g_grads, j_masks.prune_g_params, gsd, g_masks_from_jax, g, g_np, 0),
        (j_masks.mask_d_grads, j_masks.prune_d_params, dsd, d_masks_from_jax, d, d_np, 5),
    ):
        init = j_masks.init_g_masks(g_np) if module is g else j_masks.init_d_masks(d_np)
        freeze, prune = _random_masks(init, seed), _random_masks(init, seed + 1)
        grads = jax.tree.map(lambda x: jnp.asarray(rand(np.shape(x), seed + 2)), jparams)
        want = conv(jmask(grads, freeze, prune))
        pf = {k: t(v) for k, v in masks_from(freeze).items()}
        pp = {k: t(v) for k, v in masks_from(prune).items()}
        got = p_masks.mask_grads({k: t(v) for k, v in conv(grads).items()}, pf, pp)
        for k, v in module.named_parameters():
            np.testing.assert_array_equal(n(got[k]), want[k].reshape(v.shape), err_msg=k)
        want_p = conv(jprune(jparams, prune))
        p_masks.prune_params(module, pp)
        for k, v in module.named_parameters():
            np.testing.assert_array_equal(n(v), want_p[k].reshape(v.shape), err_msg=k)
        merged = p_masks.merge_prune(pf, pp)
        want_m = masks_from(j_masks.merge_prune(freeze, prune))
        assert all(np.array_equal(n(merged[k]), want_m[k]) for k in want_m)


# ---------------------------------------------------------------------------
# the four phases and run_iteration against rick_tpu's make_train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_train():
    """rick_tpu's phases and a state two iterations in (i = 0 in warmup with
    R1, i = 1 a plain one), as numpy."""
    tcfg = JTrainConfig(**TC)
    g, d = _jax_params()
    state = j_init_train_state(jax.random.key(0), JG, JD, tcfg, g_params=g, d_params=d)
    phases = make_train_step(JG, JD, tcfg)
    for i in range(2):
        state, _ = j_run_iteration(phases, state, j(rand((2, 3, SIZE, SIZE), 50 + i)), jax.random.key(7), i, tcfg)
    state = jax.tree.map(np.asarray, state)
    # Lift every second moment to at least 1e-2 of its tensor's largest:
    # where v ~ 0, Adam turns the rounding noise of a near-zero gradient into
    # a step of up to lr, and the two sides would part for no fault of
    # either.  Any v is a valid state; both sides start from this one.
    for opt in ("g_opt", "d_opt"):
        state[opt]["v"] = jax.tree.map(lambda v: v + np.float32(1e-2) * v.max(), state[opt]["v"])
    return phases, tcfg, state


def _jax_state(state_np):
    return jax.tree.map(jnp.asarray, state_np)


def jax_draws(key, step: int, tag: int, batch: int, tcfg) -> Draws:
    """The draws of rick_tpu's phase `tag` at `step`, recomputed outside its
    jit: `_phase_key`, the k1-k4 of `_sample_latent`, `_layer_noise` of
    keys[1], and for the path phase normal(keys[2]) / sqrt(H * W)."""
    keys = jax.random.split(_phase_key(key, step, tag), 4 if tag == 0 else 3)
    k1, k2, k3, k4 = jax.random.split(keys[0], 4)
    z1 = jax.random.normal(k1, (batch, tcfg.latent), jnp.float32)
    z2 = jax.random.normal(k2, (batch, tcfg.latent), jnp.float32)
    inject = jnp.where(jax.random.bernoulli(k3, tcfg.mixing), jax.random.randint(k4, (), 1, JG.n_latent), JG.n_latent)
    noise = _layer_noise(JG, None, batch, keys[1], None)
    noise_img = None
    if tag == 2:
        noise_img = t(jax.random.normal(keys[2], (batch, 3, SIZE, SIZE)) / jnp.sqrt(jnp.float32(SIZE * SIZE)))
    return Draws(t(z1), t(z2), int(inject), [t(x) for x in noise], noise_img)


# Post-step params.  One Adam step moves an entry by lr * g / sqrt(v_hat),
# and the two sides sum the gradients in another order (R1 and path length
# through a double backward), so an error dg in an entry's gradient moves it
# by about lr * dg / sqrt(v_hat).  The tolerance is that propagation of a
# gradient error of `grad` times the tensor's largest gradient, plus 1% of
# lr, plus 1e-6 of max|ref| for params that do not step; an EMA copy moves
# by (1 - accum) of that.  Adam's v: `v` of max|ref|.  Losses and scores,
# O(1) numbers that may cancel to near zero (a mean score): `loss`, relative
# and absolute.  A whole iteration chains the phases, each from params that
# already differ so: gradients and losses get ten times a phase's tolerance,
# and v 1e-2, for sums such as a noise weight's gradient, over every pixel
# of a layer, that cancel to a small part of their terms.
PHASE_TOL = dict(grad=1e-5, v=1e-4, loss=1e-5)
ITER_TOL = dict(grad=1e-4, v=1e-2, loss=1e-4)
TCFG = TrainConfig(**TC)


def _step_atol(v, count, beta2, lr, grad_tol):
    """Per-entry tolerance of one Adam step (see above)."""
    atol = 1e-2 * lr
    if count:
        v_hat = v / (1.0 - beta2**count)
        atol = atol + lr * grad_tol * np.sqrt(v.max() / (1.0 - beta2)) / (np.sqrt(v_hat) + 1e-8)
    return atol


def _compare(port, want_np, tol, models=("g", "g_ema", "d", "d_ema")):
    """The params of `models` entry by entry, Adam's state, the mean path
    length."""
    gsd = lambda tree: generator_state_dict_from_jax(JG, tree)  # noqa: E731
    dsd = lambda tree: discriminator_state_dict_from_jax(JD, tree)  # noqa: E731
    for name in models:
        conv = gsd if name[0] == "g" else dsd
        want = conv(want_np[name])
        opt = want_np[name[0] + "_opt"]
        v_ref, c_ref = conv(opt["v"]), conv(opt["count"])
        beta2, lr = (TCFG.g_beta2, TCFG.g_lr) if name[0] == "g" else (TCFG.d_beta2, TCFG.d_lr)
        share = 1.0 - TCFG.ema_accum if name.endswith("_ema") else 1.0
        for k, v in getattr(port, name).state_dict().items():
            want_k = want[k].reshape(v.shape)
            count = int(c_ref[k].reshape(-1)[0]) if k in c_ref else 0
            atol = 1e-6 * np.abs(want_k).max()
            if count:
                atol = atol + share * _step_atol(v_ref[k].reshape(v.shape), count, beta2, lr, tol["grad"])
            excess = np.abs(n(v) - want_k) - atol
            assert np.all(excess <= 0), f"{name}.{k}: {int((excess > 0).sum())} entries, up to {excess.max():.3e} over"
    for opt, module, trainable, jopt, conv in ((port.g_opt, port.g, p_masks.g_trainable, want_np["g_opt"], gsd),
                                               (port.d_opt, port.d, p_masks.d_trainable, want_np["d_opt"], dsd)):
        params = trainable_params(module, trainable)
        counts, v = p_adam.step_counts(opt, params), p_adam.exp_avg_sq(opt, params)
        jc, jv = conv(jopt["count"]), conv(jopt["v"])
        for k, p in module.named_parameters():
            assert counts.get(k, 0) == int(jc[k].reshape(-1)[0]), k
            if k in params:
                close(v[k], jv[k].reshape(p.shape), rtol=0, atol_frac=tol["v"])
    np.testing.assert_allclose(n(port.mean_path_length), want_np["mean_path_length"], rtol=tol["loss"], atol=tol["loss"])


def _port_state(state_np, tcfg):
    return train_state_from_jax(PG, PD, state_np, tcfg=TrainConfig(**TC), device="cpu")


def test_train_state_from_jax_carries_everything(jax_train):
    _, tcfg, state_np = jax_train
    _compare(_port_state(state_np, tcfg), state_np, PHASE_TOL)


STEP = 4  # a path iteration, after warmup


@pytest.mark.parametrize("phase", ["d", "r1", "g", "path"])
def test_phase_matches_jax(jax_train, phase):
    """Each phase after warmup; run_iteration at i = 0 covers the warmup
    gating of the D, R1 and G phases."""
    warmup = False
    phases, tcfg, state_np = jax_train
    port = _port_state(state_np, tcfg)
    key = jax.random.key(11)
    real = rand((2, 3, SIZE, SIZE), 60)
    js, wflag = _jax_state(copy.deepcopy(state_np)), jnp.asarray(warmup)
    if phase == "d":
        js, jm, _ = phases["d"](js, j(real), key, STEP, wflag)
        pm, _ = p_steps.d_phase(port, TrainConfig(**TC), t(real), jax_draws(key, STEP, 0, 2, tcfg), warmup)
        got, want = [pm["d"], pm["real_score"], pm["fake_score"]], [jm["d"], jm["real_score"], jm["fake_score"]]
    elif phase == "r1":
        js, want = phases["r1"](js, j(real), wflag)
        got = p_steps.r1_phase(port, TrainConfig(**TC), t(real), warmup)
        got, want = [got], [want]
    elif phase == "g":
        js, want = phases["g"](js, key, STEP, wflag, jnp.asarray(True))
        got = [p_steps.g_phase(port, TrainConfig(**TC), jax_draws(key, STEP, 1, 2, tcfg), warmup, do_ema=True)]
        want = [want]
    else:
        js, jp, jl = phases["path"](js, key, STEP, wflag)
        got = p_steps.path_phase(port, TrainConfig(**TC), jax_draws(key, STEP, 2, 1, tcfg), warmup)
        want = [jp, jl]
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=PHASE_TOL["loss"], atol=PHASE_TOL["loss"])
    _compare(port, jax.tree.map(np.asarray, js), PHASE_TOL)


@pytest.mark.parametrize("i", [0, 5, 16])
def test_run_iteration_matches_jax(jax_train, i):
    """i = 0: warmup with R1; 5: D and G with the EMA in the G phase; 16: all
    four phases, the EMA after the path phase."""
    phases, tcfg, state_np = jax_train
    port = _port_state(state_np, tcfg)
    key = jax.random.key(13)
    real = rand((2, 3, SIZE, SIZE), 70 + i)
    js, jm = j_run_iteration(phases, _jax_state(copy.deepcopy(state_np)), j(real), key, i, tcfg)
    draws = {"d": jax_draws(key, i, 0, 2, tcfg), "g": jax_draws(key, i, 1, 2, tcfg), "path": jax_draws(key, i, 2, 1, tcfg)}
    pm = run_iteration(port, TrainConfig(**TC), t(real), i, draws=draws)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(n(pm[k]), n(jm[k]), rtol=ITER_TOL["loss"], atol=ITER_TOL["loss"], err_msg=k)
    _compare(port, jax.tree.map(np.asarray, js), ITER_TOL)


def test_init_train_state_refuses_what_is_not_ported():
    """augment starts at p = augment_p (0 for the adaptive p), as rick_tpu's
    state; bf16 is the phases' compute dtype, so a bf16 state is the f32
    state (f32 params, the same values from the same seed)."""
    from rick_tpu_torch.train import init_train_state

    rng = torch.Generator().manual_seed(0)
    for augment_p in (0.0, 0.3):
        tcfg = TrainConfig(augment=True, augment_p=augment_p)
        state = init_train_state(PG, PD, tcfg, rng=rng, device="cpu")
        want = j_init_train_state(jax.random.key(0), JG, JD, JTrainConfig(augment=True, augment_p=augment_p))
        assert float(state.ada_p) == np.float32(augment_p) == float(want["ada_p"])
        assert not state.ada_stats.any() and float(state.r_t) == 0.0
    states = [init_train_state(PG, PD, TrainConfig(augment=False, bf16=bf16), rng=torch.Generator().manual_seed(1),
                               device="cpu") for bf16 in (False, True)]
    for name in ("g", "d", "g_ema", "d_ema"):
        a, b = (getattr(s, name).state_dict() for s in states)
        assert a.keys() == b.keys()
        assert all(b[k].dtype == torch.float32 and torch.equal(a[k], b[k]) for k in a), name
