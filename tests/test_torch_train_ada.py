"""The port's training phases with ADA against `rick_tpu`'s `make_train_step`
with `augment=True`, on the CPU at 16px and margin 44.

The start state is `test_torch_train`'s (two JAX iterations in, second
moments lifted) with p = 0.6 and 254 predictions pooled, so that the D
phase's two real predictions make the ADA update fire.  Each phase's draws
are JAX's, recomputed outside its jit; its ADA matrices are `rick_tpu`'s
`sample_affine` / `sample_color` of kg, kc = split(keys[2]) of the phase's
key, at the p the phase starts from.  Compared as in `test_torch_train`:
losses, post-step params, Adam's state, and ada_p, ada_stats and r_t within
1e-6; but D's params after a whole iteration with R1 per tensor in norm
(`_compare_d_steps_in_norm`).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.augment.ada import sample_affine as j_sample_affine
from rick_tpu.augment.ada import sample_color as j_sample_color
from rick_tpu.train import TrainConfig as JTrainConfig
from rick_tpu.train import make_train_step
from rick_tpu.train import run_iteration as j_run_iteration
from rick_tpu.train.steps import _phase_key
from rick_tpu_torch.ckpt import discriminator_state_dict_from_jax, train_state_from_jax
from rick_tpu_torch.train import TrainConfig, run_iteration
from rick_tpu_torch.train import steps as p_steps
from tests.test_torch_train import (  # noqa: F401
    ITER_TOL,
    JD,
    JG,
    PD,
    PG,
    PHASE_TOL,
    SIZE,
    _compare,
    _jax_state,
    jax_draws,
    jax_train,
)
from tests.torch_port_helpers import j, n, one_torch_thread, rand, t  # noqa: F401

MARGIN = SIZE // 2 + SIZE // 4 + 32  # 44, ada.py's rule
TC_ADA = dict(batch=2, augment=True, warmup_iter=1, ada_margin=MARGIN)
P0, POOLED = 0.6, (100.0, 254.0)  # r_t after the update ~0.4, far from the target 0.6
ADA_TOL = 1e-6


@pytest.fixture(scope="module")
def jax_ada(jax_train):
    _, _, state_np = jax_train
    state_np = copy.deepcopy(state_np)
    state_np["ada_p"] = np.float32(P0)
    state_np["ada_stats"] = np.asarray(POOLED, np.float32)
    tcfg = JTrainConfig(**TC_ADA)
    return make_train_step(JG, JD, tcfg), tcfg, state_np


def ada_draws(key, step: int, tag: int, batch: int, p: float, tcfg):
    """`jax_draws` with the ADA matrices of phase `tag` (0: D, 2 * batch
    images; 1: G) at probability p."""
    draws = jax_draws(key, step, tag, batch, tcfg)
    keys = jax.random.split(_phase_key(key, step, tag), 4 if tag == 0 else 3)
    kg, kc = jax.random.split(keys[2])
    size = 2 * batch if tag == 0 else batch
    draws.ada_G = t(j_sample_affine(kg, jnp.float32(p), size, SIZE, SIZE))
    draws.ada_C = t(j_sample_color(kc, jnp.float32(p), size))
    return draws


def _port(state_np):
    return train_state_from_jax(PG, PD, state_np, tcfg=TrainConfig(**TC_ADA), device="cpu")


# R1's gradient is discontinuous where a leaky-ReLU pre-activation crosses 0
# (|grad_x D|^2 takes the slopes).  At i = 16 the D phase leaves the two
# sides' D within a small part of lr of each other, and a pre-activation
# sits close enough to its kink that r1 moves by far more than that; the
# entries R1 then steps through it differ by a good part of lr.  So D's step
# over the whole iteration is held per tensor in norm, as `chip_smoke.py`
# phase 8 holds the card against the CPU: 1% of the step, or 1e-6 of
# max|ref| per entry for a tensor that does not move.  From JAX's post-D
# state, R1 holds PHASE_TOL entry by entry
# (`test_ada_r1_from_jaxs_post_d_state_matches_jax`).
STEP_NORM_TOL = 1e-2


def _compare_d_steps_in_norm(port, start_np, want_np):
    start = discriminator_state_dict_from_jax(JD, start_np["d"])
    want = discriminator_state_dict_from_jax(JD, jax.tree.map(np.asarray, want_np["d"]))
    for k, v in port.d.state_dict().items():
        s_ref = want[k].reshape(v.shape) - start[k].reshape(v.shape)
        s_got = n(v) - start[k].reshape(v.shape)
        allowed = STEP_NORM_TOL * np.linalg.norm(s_ref) + 1e-6 * np.abs(want[k]).max() * np.sqrt(v.numel())
        assert np.linalg.norm(s_got - s_ref) <= allowed, k


def _compare_ada(port, js):
    for k in ("ada_p", "ada_stats", "r_t"):
        np.testing.assert_allclose(n(getattr(port, k)), np.asarray(js[k]), rtol=ADA_TOL, atol=ADA_TOL, err_msg=k)


STEP = 4


@pytest.mark.parametrize("phase", ["d", "g"])
def test_ada_phase_matches_jax(jax_ada, phase):
    """The D phase (augment of reals and fakes in one call, the p update
    firing) and the G phase (augment under autograd), after warmup."""
    phases, tcfg, state_np = jax_ada
    port = _port(state_np)
    key = jax.random.key(21)
    real = rand((2, 3, SIZE, SIZE), 80)
    js, wflag = _jax_state(copy.deepcopy(state_np)), jnp.asarray(False)
    if phase == "d":
        js, jm, j_real_aug = phases["d"](js, j(real), key, STEP, wflag)
        pm, real_aug = p_steps.d_phase(port, TrainConfig(**TC_ADA), t(real), ada_draws(key, STEP, 0, 2, P0, tcfg),
                                       False)
        got = [pm[k] for k in ("d", "real_score", "fake_score", "ada_p", "r_t")]
        want = [jm[k] for k in ("d", "real_score", "fake_score", "ada_p", "r_t")]
        assert float(jm["ada_p"]) != P0  # the update fired
        np.testing.assert_allclose(n(real_aug), np.asarray(j_real_aug), rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(j_real_aug)).max()))
    else:
        js, want = phases["g"](js, key, STEP, wflag, jnp.asarray(True))
        got = [p_steps.g_phase(port, TrainConfig(**TC_ADA), ada_draws(key, STEP, 1, 2, P0, tcfg), False, do_ema=True)]
        want = [want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=PHASE_TOL["loss"], atol=PHASE_TOL["loss"])
    _compare(port, jax.tree.map(np.asarray, js), PHASE_TOL)
    _compare_ada(port, js)


@pytest.mark.parametrize("i", [0, 16])
def test_ada_run_iteration_matches_jax(jax_ada, i):
    """i = 0: warmup with R1 on the augmented reals; 16: all four phases.
    The G phase's matrices are drawn at the p the D phase left."""
    phases, tcfg, state_np = jax_ada
    port = _port(state_np)
    key = jax.random.key(23)
    real = rand((2, 3, SIZE, SIZE), 90 + i)
    js, jm = j_run_iteration(phases, _jax_state(copy.deepcopy(state_np)), j(real), key, i, tcfg)
    p_g = float(jm["ada_p"])
    assert p_g != P0
    draws = {"d": ada_draws(key, i, 0, 2, P0, tcfg), "g": ada_draws(key, i, 1, 2, p_g, tcfg),
             "path": jax_draws(key, i, 2, 1, tcfg)}
    pm = run_iteration(port, TrainConfig(**TC_ADA), t(real), i, draws=draws)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(n(pm[k]), n(jm[k]), rtol=ITER_TOL["loss"], atol=ITER_TOL["loss"], err_msg=k)
    if i % tcfg.d_reg_every == 0 and i >= tcfg.warmup_iter:
        _compare(port, jax.tree.map(np.asarray, js), ITER_TOL, models=("g", "g_ema", "d_ema"))
        _compare_d_steps_in_norm(port, state_np, js)
    else:
        _compare(port, jax.tree.map(np.asarray, js), ITER_TOL)
    _compare_ada(port, js)


def test_ada_r1_from_jaxs_post_d_state_matches_jax(jax_ada):
    """R1 on JAX's augmented reals from JAX's state after the D phase of
    i = 16 (the state whose kink the iteration test meets), entry by entry."""
    phases, tcfg, state_np = jax_ada
    real = rand((2, 3, SIZE, SIZE), 90 + 16)
    js, _, real_aug = phases["d"](_jax_state(copy.deepcopy(state_np)), j(real), jax.random.key(23), 16,
                                  jnp.asarray(False))
    port = _port(jax.tree.map(np.asarray, js))
    js, want = phases["r1"](js, real_aug, jnp.asarray(False))
    got = p_steps.r1_phase(port, TrainConfig(**TC_ADA), t(np.asarray(real_aug)), False)
    np.testing.assert_allclose(n(got), n(want), rtol=PHASE_TOL["loss"], atol=PHASE_TOL["loss"])
    _compare(port, jax.tree.map(np.asarray, js), PHASE_TOL)


def test_sample_draws_adds_the_ada_matrices_last():
    """With augment, the D draws carry 2B matrices and the G draws B, drawn
    after the others: the latents and noise are those of a run without
    augment from the same generator state."""
    gcfg = PG
    plain = p_steps.sample_draws(torch.Generator().manual_seed(5), gcfg, TrainConfig(augment=False), 2)
    ada = p_steps.sample_draws(torch.Generator().manual_seed(5), gcfg, TrainConfig(**TC_ADA), 2,
                               ada_p=torch.tensor(0.5), ada_batch=4)
    assert plain.ada_G is None and plain.ada_C is None
    assert ada.ada_G.shape == (4, 3, 3) and ada.ada_C.shape == (4, 4, 4)
    for a, b in zip([plain.z1, plain.z2, plain.inject_index] + plain.noise, [ada.z1, ada.z2, ada.inject_index] + ada.noise):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ADA matrices"):
        p_steps.d_phase(_port_from_init(), TrainConfig(**TC_ADA), torch.zeros(2, 3, SIZE, SIZE), plain, False)


def _port_from_init():
    from rick_tpu_torch.train import init_train_state

    return init_train_state(PG, PD, TrainConfig(**TC_ADA), rng=torch.Generator().manual_seed(0), device="cpu")
