"""Shared helpers of the `rick_tpu_torch` parity tests.

The port is checked against `rick_tpu` on identical inputs: arrays are made
with numpy from a seed and handed to both sides, and weights go from a
`rick_tpu` param pytree through the port's converter into its modules.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rick_tpu_torch.ckpt import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    inception_state_dict_from_jax,
)
from rick_tpu_torch.metrics import InceptionV3, inception_from_params, randomize_bn  # noqa: F401
from rick_tpu_torch.nn import Discriminator, Generator


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run has several workers on one host: keep torch to one
    thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def j(a) -> jnp.ndarray:
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def close(got, want, *, rtol: float, atol_frac: float) -> None:
    """|got - want| <= atol_frac * max|want| + rtol * |want|."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = atol_frac * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def perturb_zeros(params, seed: int, scale: float = 0.1):
    """Replace every all-zero leaf (biases, noise weights) by small random
    values, so that parity also covers the bias and noise paths."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for i, leaf in enumerate(leaves):
        a = np.asarray(leaf)
        if a.size and not np.any(a):
            a = rand(a.shape, seed + i, scale)
        out.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, out)


def port_generator(gcfg, params) -> Generator:
    g = Generator(
        gcfg.size, gcfg.style_dim, gcfg.n_mlp, gcfg.channel_multiplier,
        gcfg.blur_kernel, gcfg.lr_mlp, rng=torch.Generator().manual_seed(0),
    )
    sd = generator_state_dict_from_jax(gcfg, params)
    g.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    return g.eval()


def port_discriminator(dcfg, params) -> Discriminator:
    d = Discriminator(
        dcfg.size, dcfg.channel_multiplier, dcfg.blur_kernel, dcfg.stddev_group,
        dcfg.stddev_feat, rng=torch.Generator().manual_seed(0),
    )
    sd = discriminator_state_dict_from_jax(dcfg, params)
    d.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    return d.eval()


def port_inception(params, *, dtype=torch.float32, channels_last: bool = False) -> InceptionV3:
    """The port's InceptionV3 on the CPU from `rick_tpu`'s flat Inception params."""
    return inception_from_params(inception_state_dict_from_jax(params), device="cpu", dtype=dtype,
                                 channels_last=channels_last)
