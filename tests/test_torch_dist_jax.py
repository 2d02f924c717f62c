"""The port's data-parallel path on 2 gloo ranks (CPU, 8px) against
`rick_tpu` on a 2-device mesh (`rick_tpu.dist.make_mesh(2)`, two of the 8
virtual devices of tests/conftest.py): one `run_iteration` with every phase
(D, R1, G, path length, the EMA) from the same state with JAX's own draws
handed to the port, and the image-sharded Fisher accumulation (rick_tpu's
`mesh=` path) with the registered noise on both sides."""

import jax
import jax.numpy as jnp
import numpy as np

from rick_tpu.dist import make_mesh, replicate, shard_batch
from rick_tpu.nn import DiscriminatorConfig as JDCfg
from rick_tpu.nn import GeneratorConfig as JGCfg
from rick_tpu.nn.generator import _layer_noise
from rick_tpu.train import TrainConfig as JTrainConfig
from rick_tpu.train import fisher as jf
from rick_tpu.train import make_train_step
from rick_tpu.train import run_iteration as j_run_iteration
from rick_tpu.train.steps import _phase_key
from rick_tpu_torch.ckpt import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    train_state_from_jax,
)
from rick_tpu_torch.train import Draws, TrainConfig
from tests.torch_dist_workers import (
    ITER_TOL,
    PD,
    PG,
    REPLICATED,
    SIZE,
    fims_worker,
    phases_worker,
    run_ranks,
    start_tree,
    state_arrays,
)
from tests.torch_port_helpers import j, one_torch_thread, rand, t  # noqa: F401

JG, JD = JGCfg(size=SIZE), JDCfg(size=SIZE)
I = 16  # D, R1, G and the path phase (path batch 1: whole on each rank, as on each device of the mesh)


def jax_draws(key, step: int, tag: int, batch: int, tcfg) -> Draws:
    """rick_tpu's draws of phase `tag` at `step`, recomputed outside its jit
    (tests/test_torch_train.py's `jax_draws` at this size)."""
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


def test_one_iteration_on_two_ranks_matches_rick_tpu_on_a_two_device_mesh():
    """rick_tpu's jitted phases on the mesh (the global batch sharded, the
    state replicated) against the port's 2 ranks, each on its row: the
    state after the iteration within ITER_TOL (tests/test_torch_train.py's
    rule for a whole iteration against rick_tpu), and the metrics."""
    tree = start_tree()
    tree["ada_stats"] = np.zeros(2, np.float32)
    jt = JTrainConfig(**REPLICATED)
    mesh = make_mesh(2)
    key, real = jax.random.key(13), rand((2, 3, SIZE, SIZE), 70)
    state = replicate(mesh, jax.tree.map(jnp.asarray, tree))
    js, jm = j_run_iteration(make_train_step(JG, JD, jt), state, shard_batch(mesh, j(real)), key, I, jt)
    want = state_arrays(train_state_from_jax(PG, PD, jax.tree.map(np.asarray, js), tcfg=TrainConfig(**REPLICATED),
                                             device="cpu"))
    draws = {"d": jax_draws(key, I, 0, 2, jt), "g": jax_draws(key, I, 1, 2, jt), "path": jax_draws(key, I, 2, 1, jt)}
    outs = run_ranks(phases_worker, 2, tree, [(REPLICATED, "iteration", real, draws, I, ITER_TOL)], [want])
    assert outs[0][0]["error"] is None, outs[0][0]["error"]
    assert outs[0][0]["digest"] == outs[1][0]["digest"]
    got = outs[0][0]["metrics"]
    assert set(got) == set(jm)
    for k in jm:
        np.testing.assert_allclose(got[k], float(jm[k]), rtol=ITER_TOL["loss"], atol=ITER_TOL["loss"], err_msg=k)


def test_sharded_fisher_accumulation_matches_rick_tpus_mesh_path():
    """4 images, 2 per rank / device, the registered noise: every FIM entry
    within 1e-4 relative plus 2e-5 of its tensor's largest
    (tests/test_torch_fisher.py's tolerance against rick_tpu)."""
    tree = start_tree()
    noises, reals = rand((4, 512), 15), rand((4, 3, SIZE, SIZE), 16)
    mesh = make_mesh(2)
    g_ema, d_ema = (replicate(mesh, jax.tree.map(jnp.asarray, tree[k])) for k in ("g_ema", "d_ema"))
    fg, fd = jf.accumulate_fims(JG, JD, g_ema, d_ema, shard_batch(mesh, j(noises)), shard_batch(mesh, j(reals)),
                                jax.random.key(0), batch=2, const_noise=True, mesh=mesh)
    want = {**{f"g.{k}": v for k, v in generator_state_dict_from_jax(JG, jax.tree.map(np.asarray, fg)).items()},
            **{f"d.{k}": v for k, v in discriminator_state_dict_from_jax(JD, jax.tree.map(np.asarray, fd)).items()}}
    outs = run_ranks(fims_worker, 2, tree, [(noises, reals, True)], [want])
    assert outs[0][0]["digest"] == outs[1][0]["digest"]
    assert outs[0][0]["excess"] <= 0, outs[0][0]["excess"]
