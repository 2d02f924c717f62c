"""Resume across the two packages, and the reference `.pt` written by the
port: a 16px train state in `rick_tpu`'s `.state.npz` format read and
written by both, the port's 5-key `.pt` read by `rick_tpu`, and the
snapshot of `ckpt.async_io` against in-place updates."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.ckpt import (
    discriminator_state_dict_from_params,
    generator_params_from_state_dict as j_generator_params_from_state_dict,
    generator_state_dict_from_params,
    load_torch_file,
    save_torch_file,
)
from rick_tpu.ckpt.native import _flatten as j_flatten
from rick_tpu.ckpt.native import load_state as j_load_state
from rick_tpu.ckpt.native import save_state as j_save_state
from rick_tpu.cli.train import _save_torch_ckpt as j_save_torch_ckpt
from rick_tpu.nn import DiscriminatorConfig as JD
from rick_tpu.nn import GeneratorConfig as JG
from rick_tpu.nn import generator_apply
from rick_tpu.train import TrainConfig as JT
from rick_tpu.train import init_train_state as j_init_train_state
from rick_tpu_torch.ckpt import (
    load_state,
    save_state,
    state_dicts,
    torch_checkpoint,
    train_state_from_jax,
    train_state_to_jax,
)
from rick_tpu_torch.ckpt.async_io import AsyncSaver, Snapshot, atomic_write
from rick_tpu_torch.ckpt.native import flatten, unflatten
from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
from rick_tpu_torch.train import TrainConfig
from tests.torch_port_helpers import close, one_torch_thread, rand  # noqa: F401

SIZE = 16
TC = dict(batch=2, augment=False, warmup_iter=2)


def _trained_leaf(model: str, path: str) -> bool:
    """Is the leaf at `path` of model g/d one that `rick_tpu`'s Adam steps?"""
    if model == "g":
        return path.startswith("convs/")
    return path.startswith(("final_conv/", "final_linear/")) or (path.startswith("convs/") and not path.startswith("convs/0/"))


@pytest.fixture(scope="module")
def jax_state():
    """A 16px `rick_tpu` train state with every leaf drawn: weights, Adam
    v and counts of the leaves that step (zeros and 0 for the others, as
    training leaves them), 0/1 masks, scalars.  Returns it as a numpy tree
    and as `rick_tpu`'s pytree."""
    state = j_init_train_state(jax.random.key(3), JG(size=SIZE), JD(size=SIZE), JT(**TC))
    flat = j_flatten(state)
    rng = np.random.default_rng(11)
    out = {}
    for k, v in flat.items():
        top, _, rest = k.partition("/")
        if top in ("g_opt", "d_opt"):
            kind, _, path = rest.partition("/")
            if not _trained_leaf(top[0], path):
                out[k] = np.zeros_like(v)
            elif kind == "count":
                out[k] = np.float32(rng.integers(1, 9))
            else:
                out[k] = np.abs(rng.standard_normal(v.shape)).astype(np.float32) * 1e-3
        elif top.endswith(("_freeze", "_prune")):
            out[k] = (rng.random(v.shape) < 0.3).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)

    def leaf(path, _):
        return jnp.asarray(out["/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)])

    return unflatten(out), jax.tree_util.tree_map_with_path(leaf, state)


def _port(tree):
    return train_state_from_jax(GeneratorConfig(SIZE), DiscriminatorConfig(SIZE),
                                jax.tree_util.tree_map(lambda x: np.array(x), tree), tcfg=TrainConfig(**TC), device="cpu")


def test_flatten_keys_are_rick_tpus(jax_state):
    tree, state = jax_state
    assert flatten(tree).keys() == j_flatten(state).keys()


def test_rick_tpu_npz_loads_into_the_port(jax_state, tmp_path):
    """Saved by `rick_tpu`, loaded by the port: the same TrainState as
    `train_state_from_jax` of the tree itself, and every leaf back."""
    _, state = jax_state
    path = str(tmp_path / "000007.state.npz")
    j_save_state(path, state, step=7, extra={"best_fid": 12.5})
    tree, manifest = load_state(path)
    assert manifest == {"step": 7, "best_fid": 12.5}
    got = state_dicts(_port(tree))
    want = state_dicts(_port(state))
    for part in got:
        if isinstance(got[part], torch.Tensor):
            assert torch.equal(got[part], want[part]), part
            continue
        for sub in got[part]:
            a, b = got[part][sub], want[part][sub]
            if isinstance(a, dict):
                assert a.keys() == b.keys() and all(
                    torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a), (part, sub)
            else:
                assert torch.equal(a, b), (part, sub)
    flat_back = flatten(train_state_to_jax(_port(tree)))
    for k, v in j_flatten(state).items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)


def test_port_npz_loads_into_rick_tpu(jax_state, tmp_path):
    tree, state = jax_state
    path = str(tmp_path / "000009.state.npz")
    save_state(path, train_state_to_jax(_port(tree)), step=9, extra={"best_fid": 3.25})
    template = j_init_train_state(jax.random.key(0), JG(size=SIZE), JD(size=SIZE), JT(**TC))
    loaded, manifest = j_load_state(path, template)
    assert manifest == {"step": 9, "best_fid": 3.25}
    want, got = j_flatten(state), j_flatten(loaded)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_pt_gives_rick_tpu_the_same_g_ema_images(jax_state, tmp_path):
    tree, _ = jax_state
    port = _port(tree)
    path = tmp_path / "000009.pt"
    torch.save(torch_checkpoint(port, TrainConfig(**TC)), path)
    ckpt = load_torch_file(str(path))
    assert set(ckpt) == {"g_ema", "g", "d", "g_optim", "d_optim"}
    params = j_generator_params_from_state_dict(JG(size=SIZE), ckpt["g_ema"])
    z = rand((3, 512), 0)
    want, _ = generator_apply(JG(size=SIZE), params, [jnp.asarray(z)])
    with torch.no_grad():
        got, _ = port.g_ema([torch.from_numpy(z)])
    close(got, want, rtol=0, atol_frac=1e-4)


def _same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def test_port_optim_state_dicts_match_rick_tpus_ckpt(jax_state, tmp_path):
    """g_optim / d_optim of the port's `.pt` against `rick_tpu`'s
    `_save_torch_ckpt` of the same state, entry by entry."""
    tree, state = jax_state
    tcfg = TrainConfig(**TC)
    torch.save(torch_checkpoint(_port(tree), tcfg), tmp_path / "port.pt")
    host = jax.tree_util.tree_map(np.asarray, state)
    j_save_torch_ckpt(str(tmp_path / "jax.pt"), JG(size=SIZE), JD(size=SIZE), JT(**TC), host, save_torch_file,
                      generator_state_dict_from_params, discriminator_state_dict_from_params)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    for key in ("g_optim", "d_optim", "g", "d", "g_ema"):
        _same(got[key], want[key], key)
    assert len(got["g_optim"]["state"]) == 5 * 4 and len(got["d_optim"]["state"]) == 5 * 2 + 6
    assert all(st["step"] > 0 for st in got["g_optim"]["state"].values())


def test_snapshot_is_unchanged_by_an_in_place_update_after_the_submit(tmp_path):
    saver = AsyncSaver(max_pending=1)
    p = torch.arange(6, dtype=torch.float32)
    go, seen = threading.Event(), []
    saver.submit(lambda host: (go.wait(timeout=60), seen.append(host["p"].clone())), Snapshot({"p": p, "n": 3}))
    p.add_(100.0)  # the next phase's in-place update
    go.set()
    saver.close()
    assert torch.equal(seen[0], torch.arange(6, dtype=torch.float32))


def test_saver_keeps_the_newest_latest_and_raises_errors_at_close(tmp_path):
    saver = AsyncSaver()
    gate, ran = threading.Event(), []
    saver.submit(lambda host: gate.wait(timeout=60), Snapshot({}))  # holds the thread
    for i in range(3):
        saver.submit_latest("best", lambda host, i=i: ran.append(i), Snapshot({}))
    gate.set()
    saver.wait()
    assert ran == [2]

    def fail(host):
        raise OSError("disk full")

    saver.submit(fail, Snapshot({}))
    with pytest.raises(OSError, match="disk full"):
        saver.close()


def test_atomic_write_leaves_no_file_when_the_writer_fails(tmp_path):
    path = tmp_path / "x.pt"
    with pytest.raises(RuntimeError):
        with atomic_write(str(path)) as tmp:
            open(tmp, "wb").write(b"partial")
            raise RuntimeError("killed")
    assert not path.exists() and not (tmp_path / "x.pt.tmp").exists()
    with atomic_write(str(path)) as tmp:
        open(tmp, "wb").write(b"whole")
    assert path.read_bytes() == b"whole"
