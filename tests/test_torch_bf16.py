"""The port's bf16 compute (`TrainConfig(bf16=True)`, `Evaluator(gen_dtype=
torch.bfloat16)`) against `rick_tpu`'s on the CPU at 16px.

rick_tpu's `dtype=bf16` computes in bf16 only in G's first StyledConv and in
D's from-RGB conv: the f32 activation bias there promotes the sum to f32, and
every later layer casts its weight to the f32 input.  The port must compute
in bf16 exactly there.  rick_tpu runs its default route here (no
`RICK_PALLAS*`).

Torch's CPU bf16 conv and XLA's both accumulate in f32 and round once, but
XLA may keep f32 between fused bf16 elementwise ops, so the two sides agree
to about a bf16 step at the bf16 layers, not bitwise: each tolerance below
says how far.  The training phases use `test_torch_train`'s harness: JAX's
draws recomputed outside its jit, the weights through `train_state_from_jax`,
a start state two JAX iterations in (here of the bf16 phases) with Adam's
second moments lifted.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rick_tpu.metrics.evaluator import _stats_from_acts as j_stats_from_acts
from rick_tpu.metrics.inception import inception_init_np, inception_pool3
from rick_tpu.nn import blocks as jb
from rick_tpu.nn.discriminator import discriminator_apply
from rick_tpu.nn.generator import generator_apply, generator_apply_latent
from rick_tpu.ops.fused_act import fused_leaky_relu as j_fused_leaky_relu
from rick_tpu.train import TrainConfig as JTrainConfig
from rick_tpu.train import init_train_state as j_init_train_state
from rick_tpu.train import make_train_step
from rick_tpu.train import run_iteration as j_run_iteration
from rick_tpu_torch import nn as tnn
from rick_tpu_torch import ops
from rick_tpu_torch.ckpt import discriminator_state_dict_from_jax, generator_state_dict_from_jax, train_state_from_jax
from rick_tpu_torch.ckpt.convert import _styled_to_sd
from rick_tpu_torch.metrics import Evaluator
from rick_tpu_torch.metrics.evaluator import _stats_from_acts
from rick_tpu_torch.train import TrainConfig, run_iteration
from rick_tpu_torch.train import steps as p_steps
from tests.test_torch_train import JD, JG, PD, PG, SIZE, _jax_params, _jax_state, jax_draws
from tests.test_torch_train_ada import MARGIN, ada_draws
from tests.torch_port_helpers import (  # noqa: F401
    j,
    n,
    one_torch_thread,
    port_discriminator,
    port_generator,
    rand,
    randomize_bn,
    t,
)

BF16_STEP = 2.0**-8  # a bf16 ulp at 1, relative


def _rel(a, b) -> float:
    """max|a - b| / max|b|."""
    a, b = np.asarray(n(a), np.float64), np.asarray(n(b), np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _norm_rel(a, b) -> float:
    a, b = np.asarray(n(a), np.float64), np.asarray(n(b), np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def f32(x):
    """A torch tensor or a JAX array as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a) -> torch.Tensor:
    return t(a).to(torch.bfloat16)


def _jbf16(a):
    return j(a).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def models():
    g_params, d_params = _jax_params()
    return g_params, d_params, port_generator(JG, g_params), port_discriminator(JD, d_params)


# ---------------------------------------------------------------------------
# the dtype flow and the forward of G and D
# ---------------------------------------------------------------------------


def _conv_out_dtypes(module, run):
    """The output dtype of every conv module of `module` in `run()`, in call
    order, by name (a ModulatedConv2d with deferred demod returns a pair)."""
    seen, hooks = [], []
    for name, m in module.named_modules():
        if isinstance(m, (tnn.EqualConv2d, tnn.ModulatedConv2d)):
            def hook(_, __, out, name=name):
                seen.append((name, (out[0] if isinstance(out, tuple) else out).dtype))
            hooks.append(m.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_dtype_flow_is_rick_tpus(models):
    """Every feature, the image and the score have rick_tpu's dtype under
    bf16 (f32: the promotion after the first layer), and the port's convs
    compute in bf16 at G's conv1 and D's from-RGB conv and nowhere else."""
    g_params, d_params, g, d = models
    lat, x = rand((2, JG.n_latent, 512), 1), rand((2, 3, SIZE, SIZE), 2)
    with torch.no_grad():
        img, feats = g([t(lat)], input_is_latent=True, return_feats=True, dtype=torch.bfloat16)
        score, dfeats = d(t(x), dtype=torch.bfloat16)
    jimg, jfeats = generator_apply_latent(JG, g_params, j(lat), return_feats=True, dtype=jnp.bfloat16)
    jscore, jdfeats = discriminator_apply(JD, d_params, j(x), dtype=jnp.bfloat16)
    torch_of = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    assert [f.dtype for f in feats] == [torch_of[f.dtype] for f in jfeats]
    assert [f.dtype for f in dfeats] == [torch_of[f.dtype] for f in jdfeats]
    assert (img.dtype, score.dtype) == (torch_of[jimg.dtype], torch_of[jscore.dtype]) == (torch.float32,) * 2
    with torch.no_grad():
        g_convs = _conv_out_dtypes(g, lambda: g([t(lat)], input_is_latent=True, dtype=torch.bfloat16))
        d_convs = _conv_out_dtypes(d, lambda: d(t(x), dtype=torch.bfloat16))
    for convs, first in ((g_convs, "conv1.conv"), (d_convs, "convs.0.0")):
        assert [name for name, dt in convs if dt == torch.bfloat16] == [first], convs
        assert all(dt == torch.float32 for name, dt in convs if name != first)


def test_g_and_d_forward_in_bf16_match_rick_tpu(models):
    """The same weights, latents and constant noise.  G's conv1 feature, the
    one bf16 layer's output: within one bf16 step of max|ref| (a conv sum
    rounded to bf16 may land one step apart); D's from-RGB feature the same;
    every later feature, the image and the score, 1e-3 of max|ref| (f32
    layers on inputs that differ so).  And the port's bf16 outputs are ten
    times nearer rick_tpu's bf16 outputs than its f32 ones, in norm: the
    bf16 layers ran in bf16."""
    g_params, d_params, g, d = models
    lat, x = rand((2, JG.n_latent, 512), 3), rand((2, 3, SIZE, SIZE), 4)
    with torch.no_grad():
        img, feats = g([t(lat)], input_is_latent=True, return_feats=True, dtype=torch.bfloat16)
        score, dfeats = d(t(x), dtype=torch.bfloat16)
    jimg, jfeats = generator_apply_latent(JG, g_params, j(lat), return_feats=True, dtype=jnp.bfloat16)
    jscore, jdfeats = discriminator_apply(JD, d_params, j(x), dtype=jnp.bfloat16)
    assert _rel(feats[0], jfeats[0]) <= BF16_STEP and _rel(dfeats[0], jdfeats[0]) <= BF16_STEP
    for a, b in list(zip(feats[1:], jfeats[1:])) + list(zip(dfeats[1:], jdfeats[1:])) + [(img, jimg), (score, jscore)]:
        assert _rel(a, b) <= 1e-3
    jimg32 = generator_apply_latent(JG, g_params, j(lat))[0]
    jscore32 = discriminator_apply(JD, d_params, j(x))[0]
    assert _norm_rel(img, jimg) <= 0.1 * _norm_rel(img, jimg32)
    assert _norm_rel(score, jscore) <= 0.1 * _norm_rel(score, jscore32)


# ---------------------------------------------------------------------------
# the plain versions of the two bf16 instantiations
# ---------------------------------------------------------------------------


def test_fused_bias_act_on_bf16_matches_rick_tpus_fused_leaky_relu():
    """K1's bf16 form (on the CPU its plain version): a bf16 x, an f32 bias,
    an f32 y, equal to rick_tpu's `fused_leaky_relu` (x + bias promoted to
    f32 exactly: 1e-6).  The grads in each operand's dtype: gx bf16 (the f32
    cotangent rounded once), gb f32 (summed over the f32 cotangent): 1e-6
    relative to the larger of the two sides' values."""
    x, b, w = rand((2, 6, 5, 5), 5), rand((6,), 6, 0.3), rand((2, 6, 5, 5), 7)
    xt, bt = _bf16(x).requires_grad_(True), t(b).requires_grad_(True)
    y = ops.fused_leaky_relu(xt, bt)
    jy, vjp = jax.vjp(j_fused_leaky_relu, _jbf16(x), j(b))
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    assert _rel(y, jy) <= 1e-6
    gx, gb = torch.autograd.grad(y, (xt, bt), t(w))
    jgx, jgb = vjp(j(w))
    assert (gx.dtype, gb.dtype) == (torch.bfloat16, torch.float32)
    assert (jgx.dtype, jgb.dtype) == (jnp.bfloat16, jnp.float32)
    assert _rel(f32(gx), f32(jgx)) <= 1e-6 and _rel(gb, jgb) <= 1e-6


def _epi_chain_jax(out, demod, noise, nw, bias):
    """rick_tpu's plain chain at G's conv1 under bf16 (`blocks.py:147,285`,
    then `fused_leaky_relu`): bf16 operands, an f32 bias."""
    v = out * demod[:, :, None, None]
    v = v + nw * noise
    return j_fused_leaky_relu(v, bias)


@pytest.mark.parametrize("noise_batch", [2, 1])
def test_modconv_epilogue_on_bf16_matches_rick_tpus_chain(noise_batch):
    """K3's bf16 form (its plain version here) against the chain it stands
    for: values and y's dtype f32; the grads of out, demod, noise and the
    noise weight bf16, of the bias f32.  y: one bf16 step of the
    pre-activation may part the two (XLA may keep f32 between the fused bf16
    products), so BF16_STEP of max|ref|.  The grads, of max|ref|: d_out
    (elementwise) BF16_STEP; d_demod, d_noise and d_nw are bf16 sums (over
    H*W, the channels, everything), which rick_tpu's CPU reduction
    accumulates in bf16 and the port in f32 with one rounding, so 5 bf16
    steps; d_bias, an f32 sum on both sides, 1e-5."""
    B, C, H = 2, 6, 5
    args = [rand((B, C, H, H), 8), np.abs(rand((B, C), 9)) + 0.5, rand((noise_batch, 1, H, H), 10),
            np.float32(0.7), rand((C,), 11, 0.3)]
    w = rand((B, C, H, H), 12)
    pt = [_bf16(a) for a in args[:3]] + [_bf16(np.reshape(args[3], (1,))), t(args[4])]
    pt = [a.requires_grad_(True) for a in pt]
    y = ops.modconv_epilogue(*pt)
    jy, vjp = jax.vjp(_epi_chain_jax, *[_jbf16(a) for a in args[:4]], j(args[4]))
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    assert _rel(y, jy) <= BF16_STEP
    got = torch.autograd.grad(y, pt, t(w))
    want = vjp(j(w))
    assert [g_.dtype for g_ in got] == [torch.bfloat16] * 4 + [torch.float32]
    assert [w_.dtype for w_ in want] == [jnp.bfloat16] * 4 + [jnp.float32]
    for g_, w_, tol in zip(got, want, [BF16_STEP] + [5 * BF16_STEP] * 3 + [1e-5]):
        assert _rel(f32(g_).reshape(np.shape(w_)), f32(w_)) <= tol


def _styled_sd(p) -> dict:
    sd = {}
    _styled_to_sd(p, "m", sd)
    return {k[2:]: v for k, v in sd.items()}


def test_styled_conv_on_bf16_input_matches_rick_tpu():
    """A non-upsample StyledConv (G's conv1 block) on a bf16 input, through
    the port's plain chain (K3's bf16 form): the output f32, within one bf16
    step of max|ref|; the grads of the bf16 input (bf16) and of the style,
    the noise and every param (f32) within 1e-2 of max|ref| (sums over a
    layer of bf16 products, rounded in other places)."""
    p = jb.styled_conv_init(jax.random.key(3), 8, 8, 3, 16)
    p["noise_weight"], p["act_bias"] = jnp.float32(0.4), j(rand((8,), 13, 0.3))
    m = tnn.StyledConv(8, 8, 3, 16, rng=torch.Generator().manual_seed(0))
    m.load_state_dict({k: t(v) for k, v in _styled_sd(p).items()}, strict=True)
    x, s, nz, w = rand((2, 8, 4, 4), 14), rand((2, 16), 15), rand((2, 1, 4, 4), 16), rand((2, 8, 4, 4), 17)

    def f(p, x, s, nz):
        return jb.styled_conv_apply(p, x, s, nz)

    jy, vjp = jax.vjp(f, p, _jbf16(x), j(s), j(nz))
    xt, st, nt = _bf16(x).requires_grad_(True), t(s).requires_grad_(True), t(nz).requires_grad_(True)
    y = m(xt, st, nt)
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    assert _rel(y, jy) <= BF16_STEP
    params = dict(m.named_parameters())
    got = torch.autograd.grad(y, [xt, st, nt] + list(params.values()), t(w))
    jp, jx, js, jn = vjp(j(w))
    assert got[0].dtype == torch.bfloat16 and jx.dtype == jnp.bfloat16
    want = [jx, js, jn] + [_styled_sd(jp)[k] for k in params]
    for name, grad, w_ in zip(["x", "style", "noise"] + list(params), got, want):
        assert grad.dtype == (torch.bfloat16 if name == "x" else torch.float32), name
        assert _rel(f32(grad).reshape(np.shape(w_)), f32(w_)) <= 1e-2, name


# ---------------------------------------------------------------------------
# the D and G phases and run_iteration with bf16=True
# ---------------------------------------------------------------------------

TC = dict(batch=2, augment=False, warmup_iter=1, bf16=True)
TC_ADA = dict(batch=2, augment=True, augment_p=0.5, warmup_iter=1, ada_margin=MARGIN, bf16=True)


@pytest.fixture(scope="module")
def jax_bf16():
    """rick_tpu's bf16 phases and a state two of its bf16 iterations in
    (i = 0 in warmup with R1, i = 1 a plain one), Adam's second moments
    lifted to 1e-2 of each tensor's largest (as `test_torch_train`), as
    numpy."""
    tcfg = JTrainConfig(**TC)
    g, d = _jax_params()
    state = j_init_train_state(jax.random.key(0), JG, JD, tcfg, g_params=g, d_params=d)
    phases = make_train_step(JG, JD, tcfg)
    for i in range(2):
        state, _ = j_run_iteration(phases, state, j(rand((2, 3, SIZE, SIZE), 50 + i)), jax.random.key(7), i, tcfg)
    state = jax.tree.map(np.asarray, state)
    for opt in ("g_opt", "d_opt"):
        state[opt]["v"] = jax.tree.map(lambda v: v + np.float32(1e-2) * v.max(), state[opt]["v"])
    return phases, tcfg, state


def _port(state_np, tc):
    return train_state_from_jax(PG, PD, state_np, tcfg=TrainConfig(**tc), device="cpu")


def _sd(name, tree) -> dict:
    conv = generator_state_dict_from_jax if name[0] == "g" else discriminator_state_dict_from_jax
    return conv(JG if name[0] == "g" else JD, jax.tree.map(np.asarray, tree))


def _compare_steps(port, start_np, want_np, tol, models=("g", "g_ema", "d", "d_ema")):
    """The step each param took (post - start) and Adam's v, per tensor in
    norm, as `chip_smoke.py` holds the card against the CPU (its
    `by_tensor`: the one-element params of a model as one vector):
    |step_port - step_jax| <= tol * |step_jax| + (1e-3 * lr + 1e-6 *
    max|ref|) * sqrt(n): an RMS of 0.1% of lr per entry, for steps near zero
    (lr times (1 - accum) for an EMA copy), and of 1e-6 of the tensor, for
    the rounding of an update that does not move it (the EMA of a param
    that did not step); |v_port - v_jax| <= tol * |v_jax|.  Returns the
    worst error over its allowance."""
    tcfg = TrainConfig(**TC)
    worst = 0.0
    for name in models:
        start, want = _sd(name, start_np[name]), _sd(name, want_np[name])
        shapes = dict((k, v.shape) for k, v in getattr(port, name).state_dict().items())
        start, want = (chip_smoke.by_tensor({k: torch.from_numpy(np.asarray(d[k]).reshape(shapes[k])) for k in shapes})
                       for d in (start, want))
        got = chip_smoke.by_tensor(dict(getattr(port, name).state_dict()))
        lr = tcfg.g_lr if name[0] == "g" else tcfg.d_lr
        lr = lr * (1.0 - tcfg.ema_accum) if name.endswith("_ema") else lr
        for k in start:
            s_ref, s_got = want[k] - start[k], got[k] - start[k]
            allowed = tol * float(s_ref.norm()) + (1e-3 * lr + 1e-6 * float(want[k].abs().max())) * s_ref.numel() ** 0.5
            worst = max(worst, float((s_got - s_ref).norm()) / allowed)
            assert float((s_got - s_ref).norm()) <= allowed, f"the step of {name}.{k}"
    for name in {m[0] for m in models}:
        module, opt = getattr(port, name), getattr(port, name + "_opt")
        jv = _sd(name, want_np[name + "_opt"]["v"])
        params = {k: p for k, p in module.named_parameters() if p in opt.state}
        got = chip_smoke.by_tensor({k: opt.state[p]["exp_avg_sq"] for k, p in params.items()})
        ref = chip_smoke.by_tensor({k: torch.from_numpy(np.asarray(jv[k]).reshape(p.shape)) for k, p in params.items()})
        for k in ref:
            worst = max(worst, _norm_rel(got[k], ref[k]) / tol)
            assert _norm_rel(got[k], ref[k]) <= tol, f"v of {name}.{k}"
    return worst


STEP = 4  # after warmup
D_METRICS = ("d", "real_score", "fake_score")
# Losses and scores of a phase from the common start, relative and absolute;
# the steps per tensor in norm (`_compare_steps`) after a phase, and after
# a whole iteration, whose later phases start from params that already
# differ so; the metrics of those later phases (R1, G, path) relative.  Why
# these sizes: see `test_bf16_phase_matches_jax`.
LOSS_TOL, PHASE_STEP_TOL, ITER_STEP_TOL, ITER_LOSS_TOL = 1e-3, 1e-1, 2e-1, 3e-2


@pytest.mark.parametrize("phase", ["d", "g"])
def test_bf16_phase_matches_jax(jax_bf16, phase):
    """The D phase (G and D in bf16, the predictions cast to f32) and the G
    phase (G in bf16, its image f32 into D in bf16) against rick_tpu's
    `make_train_step(bf16=True)`.  Losses and scores within 1e-3 (rick_tpu's
    bf16 and f32 D phases part by 3e-3 here).  The steps per tensor in norm
    within 1e-1: the two sides' bf16 G give fakes ~2e-5 of max|ref|
    apart (f32 sums in another order after conv1), and D's bf16 from-RGB
    layer turns that into another bf16 rounding of a share of its outputs.
    At this size such a change of the fakes moves D's bf16 gradients by 2-3%
    in norm (in f32, 1e-5), and the D phase's steps by up to 6% (measured);
    over a whole iteration, where R1 and G then run on a D that differs so,
    up to 10%, and the later phases' metrics by up to 1.3%."""
    phases, tcfg, state_np = jax_bf16
    port = _port(state_np, TC)
    key = jax.random.key(11)
    real = rand((2, 3, SIZE, SIZE), 60)
    js, wflag = _jax_state(copy.deepcopy(state_np)), jnp.asarray(False)
    if phase == "d":
        js, jm, _ = phases["d"](js, j(real), key, STEP, wflag)
        pm, _ = p_steps.d_phase(port, TrainConfig(**TC), t(real), jax_draws(key, STEP, 0, 2, tcfg), False)
        got, want = [pm[k] for k in D_METRICS], [jm[k] for k in D_METRICS]
        models = ("d",)
    else:
        js, jl = phases["g"](js, key, STEP, wflag, jnp.asarray(True))
        got = [p_steps.g_phase(port, TrainConfig(**TC), jax_draws(key, STEP, 1, 2, tcfg), False, do_ema=True)]
        want, models = [jl], ("g", "g_ema", "d_ema")
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=LOSS_TOL, atol=LOSS_TOL)
    _compare_steps(port, state_np, js, PHASE_STEP_TOL, models)


@pytest.mark.parametrize("i", [0, 16])
def test_bf16_run_iteration_matches_jax(jax_bf16, i):
    """i = 0: warmup, with R1 (f32 under the flag); 16: all four phases, R1
    and path length in f32, the EMA after the path phase.  The D phase's
    metrics within LOSS_TOL, the later phases' within ITER_LOSS_TOL, the
    steps within ITER_STEP_TOL (see `test_bf16_phase_matches_jax`)."""
    phases, tcfg, state_np = jax_bf16
    port = _port(state_np, TC)
    key = jax.random.key(13)
    real = rand((2, 3, SIZE, SIZE), 70 + i)
    js, jm = j_run_iteration(phases, _jax_state(copy.deepcopy(state_np)), j(real), key, i, tcfg)
    draws = {name: jax_draws(key, i, tag, batch, tcfg)
             for name, tag, batch in (("d", 0, 2), ("g", 1, 2), ("path", 2, 1))}
    pm = run_iteration(port, TrainConfig(**TC), t(real), i, draws=draws)
    assert set(pm) == set(jm)
    for k in jm:
        tol = LOSS_TOL if k in D_METRICS + ("ada_p", "r_t") else ITER_LOSS_TOL
        np.testing.assert_allclose(n(pm[k]), n(jm[k]), rtol=tol, atol=LOSS_TOL, err_msg=k)
    _compare_steps(port, state_np, js, ITER_STEP_TOL)


@pytest.fixture(scope="module")
def jax_bf16_ada(jax_bf16):
    _, _, state_np = jax_bf16
    state_np = copy.deepcopy(state_np)
    state_np["ada_p"] = np.float32(0.5)
    return make_train_step(JG, JD, JTrainConfig(**TC_ADA)), JTrainConfig(**TC_ADA), state_np


@pytest.mark.parametrize("phase", ["d", "g"])
def test_bf16_ada_phase_matches_jax(jax_bf16_ada, phase):
    """ADA under bf16 at a fixed p = 0.5: the D phase augments its reals and
    its fakes (cast to f32 first) in one call, the G phase its f32 fakes
    under autograd, then D in bf16.  As the phases without ADA."""
    phases, tcfg, state_np = jax_bf16_ada
    port = _port(state_np, TC_ADA)
    key = jax.random.key(21)
    real = rand((2, 3, SIZE, SIZE), 80)
    js, wflag = _jax_state(copy.deepcopy(state_np)), jnp.asarray(False)
    if phase == "d":
        js, jm, _ = phases["d"](js, j(real), key, STEP, wflag)
        pm, _ = p_steps.d_phase(port, TrainConfig(**TC_ADA), t(real), ada_draws(key, STEP, 0, 2, 0.5, tcfg), False)
        got, want, models = [pm[k] for k in D_METRICS], [jm[k] for k in D_METRICS], ("d",)
    else:
        js, jl = phases["g"](js, key, STEP, wflag, jnp.asarray(True))
        got = [p_steps.g_phase(port, TrainConfig(**TC_ADA), ada_draws(key, STEP, 1, 2, 0.5, tcfg), False, do_ema=True)]
        want, models = [jl], ("g", "g_ema", "d_ema")
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=LOSS_TOL, atol=LOSS_TOL)
    _compare_steps(port, state_np, js, PHASE_STEP_TOL, models)


# ---------------------------------------------------------------------------
# Evaluator(gen_dtype=bf16)
# ---------------------------------------------------------------------------

TRUNK = dict(inception_stop_at="Mixed_6a", inception_resize_to=75)  # test_torch_evaluator's cut


def test_evaluator_generates_in_gen_dtype_as_rick_tpu(models):
    """`Evaluator(gen_dtype=torch.bfloat16)` generates the FID draws as
    rick_tpu's (`generator_apply(..., dtype=gen_dtype)`): 8 fixed latents
    with G's constant noise, through G and the cut Inception.  The images
    within 1e-3 of max|ref| of rick_tpu's bf16 images (G's f32 layers after
    a bf16 conv1 that may round a step apart), the activations and their
    mean and covariance within 1e-3 of max|ref|, and the activations 5x
    nearer rick_tpu's bf16 ones than its f32 ones, in norm."""
    g_params, _, g, _ = models
    incp = randomize_bn(inception_init_np(0), seed=3)
    j_incp = {k: jnp.asarray(v) for k, v in incp.items()}
    real = np.random.default_rng(0).integers(0, 256, (8, 3, SIZE, SIZE), dtype=np.uint8)
    ev = Evaluator(PG, fid_real_samples=real, inception_nsamples=8, batch_size=8, gen_batch=4, inception_params=incp,
                   gen_dtype=torch.bfloat16, seed=1, device="cpu", **TRUNK)
    z = np.random.default_rng(5).standard_normal((8, 512)).astype(np.float32)
    with torch.no_grad():
        imgs = g([t(z)], dtype=torch.bfloat16)[0]
    acts = ev.activations(g, t(z))
    j_acts = {}
    for dt in (jnp.bfloat16, jnp.float32):
        j_imgs = generator_apply(JG, g_params, [j(z)], dtype=dt)[0]
        j_acts[dt] = inception_pool3(j_incp, j_imgs, stop_at="Mixed_6a", resize_to=75)
        if dt == jnp.bfloat16:
            assert imgs.dtype == torch.float32 and _rel(imgs, j_imgs) <= 1e-3
    assert acts.shape == (8, 768) and _rel(acts, j_acts[jnp.bfloat16]) <= 1e-3
    for got, want in zip(_stats_from_acts(acts), j_stats_from_acts(j_acts[jnp.bfloat16])):
        assert _rel(got, want) <= 1e-3
    assert _norm_rel(acts, j_acts[jnp.bfloat16]) <= 0.2 * _norm_rel(acts, j_acts[jnp.float32])
    score = ev.compute_inception_score(g, kid=True)
    assert np.isfinite(score["fid"]) and np.isfinite(score["kid"])
