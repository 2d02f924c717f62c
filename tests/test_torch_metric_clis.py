"""The port's metric CLIs (`rick_tpu_torch.cli` fid, kid, precision_recall,
intra_lpips) against `rick_tpu.cli`'s: the same flags, and the same printed
values on tiny `.npy` sets, with both packages reading the same weight files
(written here with `torch.save` from rick_tpu's seeded VGG16 and the
seeded Inception, and named by RICK_INCEPTION_WEIGHTS,
RICK_VGG16_WEIGHTS and RICK_LPIPS_WEIGHTS); and `intra_lpips compute` of a
16px `.pt`, seeded by `--seed`.  The port's CLIs run with device="cpu".
"""

import argparse
import re
from unittest import mock

import numpy as np
import pytest
import torch

import rick_tpu.cli.fid as j_fid
import rick_tpu.cli.intra_lpips as j_intra_cli
import rick_tpu.cli.kid as j_kid
import rick_tpu.cli.precision_recall as j_pr_cli
from rick_tpu.metrics.inception import inception_init_np
from rick_tpu.metrics.vgg import vgg16_init as j_vgg16_init
from rick_tpu_torch.ckpt import vgg16_state_dict_from_jax
from rick_tpu_torch.cli import fid, intra_lpips, kid, precision_recall
from rick_tpu_torch.metrics import IntraLPIPS, load_cluster_centers
from rick_tpu_torch.metrics.lpips import _TAP_CHANNELS
from rick_tpu_torch.nn import Generator
from tests.torch_port_helpers import one_torch_thread, randomize_bn  # noqa: F401

CLIS = {"fid": (fid, j_fid), "kid": (kid, j_kid), "precision_recall": (precision_recall, j_pr_cli),
        "intra_lpips": (intra_lpips, j_intra_cli)}


class _Caught(Exception):
    pass


def _parser(main) -> argparse.ArgumentParser:
    """The parser that `main` builds, caught at its parse_args."""
    seen = []

    def grab(self, *args, **kw):
        seen.append(self)
        raise _Caught

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), pytest.raises(_Caught):
        main([])
    return seen[0]


def _spec(parser: argparse.ArgumentParser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out["subcommands"] = {name: _spec(sub) for name, sub in a.choices.items()}
        else:
            out[tuple(a.option_strings) or a.dest] = (a.dest, a.type, a.default, a.nargs, a.const, a.required,
                                                      type(a).__name__)
    return out


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flags_are_rick_tpus(name):
    """The same positionals, option strings, dests, types, defaults and
    actions (and subcommands)."""
    port, ref = CLIS[name]
    assert _spec(_parser(port.main)) == _spec(_parser(ref.main))


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    torch.save({k: torch.from_numpy(v) for k, v in randomize_bn(inception_init_np(0), seed=3).items()},
               d / "inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in vgg16_state_dict_from_jax(j_vgg16_init(seed=71)).items()},
               d / "vgg16.pth")
    rng = np.random.default_rng(72)
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy((rng.random((1, c, 1, 1)) * 0.1).astype(np.float32))
                for i, c in enumerate(_TAP_CHANNELS)}, d / "lpips_vgg.pth")
    return d


@pytest.fixture(autouse=True)
def weights_env(weight_files, monkeypatch):
    monkeypatch.setenv("RICK_INCEPTION_WEIGHTS", str(weight_files / "inception.pth"))
    monkeypatch.setenv("RICK_VGG16_WEIGHTS", str(weight_files / "vgg16.pth"))
    monkeypatch.setenv("RICK_LPIPS_WEIGHTS", str(weight_files / "lpips_vgg.pth"))
    monkeypatch.delenv("RICK_FID_HOST_SQRTM", raising=False)


def _outputs(capsys, port_main, ref_main, argv, *, np_seed=None):
    """What each side prints for `argv`, the global np.random seeded alike
    before each when `np_seed` is given."""
    lines = []
    for main, kw in ((ref_main, {}), (port_main, dict(device="cpu"))):
        if np_seed is not None:
            np.random.seed(np_seed)
        main(argv, **kw)
        lines.append(capsys.readouterr().out.strip())
    return lines


def _numbers(line: str):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", line)]


def _sets(tmp_path, n=6, size=16):
    """Two seeded image sets as .npy, one NCHW and one NHWC."""
    rng = np.random.default_rng(73)
    a = rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    b = np.clip(a * 0.5 + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32).transpose(0, 2, 3, 1)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    return str(tmp_path / "a.npy"), str(tmp_path / "b.npy")


@pytest.mark.parametrize("extra", [[], ["--bootstrap", "--n_bootstraps", "2"]])
def test_fid_cli_prints_rick_tpus_value(tmp_path, capsys, extra):
    """The FID of two sets of 6 at batch 3 through the whole Inception:
    the same line, its value within 1e-4 of rick_tpu's (6 images against
    2048 dimensions make both covariances singular)."""
    a, b = _sets(tmp_path)
    want, got = _outputs(capsys, fid.main, j_fid.main, [a, b, "--batch-size", "3"] + extra)
    assert got.split(":")[0] == want.split(":")[0] == "FID"
    assert len(_numbers(got)) == len(_numbers(want)) == (2 if extra else 1)
    for g, w in zip(_numbers(got), _numbers(want)):
        assert abs(g - w) <= 1e-4 * abs(_numbers(want)[0]) + (5e-5 if extra else 0.0)


def test_kid_cli_prints_rick_tpus_value(tmp_path, capsys):
    """KID over 5 subsets, np.random seeded alike before each side: the
    printed mean and std within 1e-5 of rick_tpu's, or one unit of the sixth
    decimal (the randomized batch-norm statistics make the activations, and
    so the MMD, large)."""
    a, b = _sets(tmp_path)
    want, got = _outputs(capsys, kid.main, j_kid.main, [a, b, "--batch-size", "3", "--n_subsets", "5"], np_seed=0)
    assert got.startswith("KID mean std: ") and want.startswith("KID mean std: ")
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-5, atol=1e-6)


def test_precision_recall_cli_prints_rick_tpus_line(tmp_path, capsys):
    """8 reals in two tight groups, 8 fakes half near one of them: the same
    line."""
    rng = np.random.default_rng(74)
    base = rng.uniform(-1, 1, (3, 3, 16, 16))
    group = [np.clip(base[i] + rng.normal(0, 0.05, (4, 3, 16, 16)), -1, 1).astype(np.float32) for i in (0, 1, 0, 2)]
    np.save(tmp_path / "real.npy", np.concatenate(group[:2]))
    np.save(tmp_path / "fake.npy", np.concatenate(group[2:]))
    want, got = _outputs(capsys, precision_recall.main, j_pr_cli.main,
                         [str(tmp_path / "real.npy"), str(tmp_path / "fake.npy"), "--batch_size", "8"])
    assert got == want
    assert 0.0 < _numbers(got)[0] < 1.0


def _centers(tmp_path, capsys) -> str:
    """Two 16px centers written by the port's `prepare` (its line is
    rick_tpu's)."""
    np.save(tmp_path / "shots.npy", np.random.default_rng(75).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32))
    argv = ["prepare", str(tmp_path / "shots.npy"), str(tmp_path / "centers"), "--size", "16"]
    intra_lpips.main(argv, device="cpu")
    assert capsys.readouterr().out.strip() == f"wrote 2 centers under {tmp_path / 'centers'}/c*/center.png"
    return str(tmp_path / "centers")


COMPUTE = ["--size", "16", "--k", "2", "--cluster_size", "3", "--batch", "4"]


def test_intra_lpips_cli_prints_rick_tpus_value(tmp_path, capsys):
    """`compute` of 4 samples (.npy) against 2 prepared centers, LPIPS at
    256 (the protocol's resize): the printed value within one unit of the
    sixth decimal."""
    centers = _centers(tmp_path, capsys)
    a, _ = _sets(tmp_path)
    want, got = _outputs(capsys, intra_lpips.main, j_intra_cli.main, ["compute", a, centers, "--n_samples", "4"] + COMPUTE)
    assert got.startswith("intra-LPIPS: ") and want.startswith("intra-LPIPS: ")
    assert abs(_numbers(got)[0] - _numbers(want)[0]) <= 1e-6


def test_intra_lpips_cli_samples_a_checkpoint_by_seed(tmp_path, capsys):
    """A 16px g_ema in a `.pt`: its samples are fixed by --seed, and the CLI
    prints IntraLPIPS.compute of the port's own CPU generation from that
    seed."""
    centers = _centers(tmp_path, capsys)
    g = Generator(16, rng=torch.Generator().manual_seed(76))
    torch.save({"g_ema": g.state_dict()}, tmp_path / "best.pt")
    pt = str(tmp_path / "best.pt")
    first, again = (intra_lpips.sample_checkpoint(pt, 16, 4, 3, torch.device("cpu")) for _ in range(2))
    assert first.shape == (4, 3, 16, 16) and torch.equal(first, again)
    assert not torch.equal(first, intra_lpips.sample_checkpoint(pt, 16, 4, 4, torch.device("cpu")))
    intra_lpips.main(["compute", pt, centers, "--n_samples", "4", "--seed", "3"] + COMPUTE, device="cpu")
    got = capsys.readouterr().out.strip()
    il = IntraLPIPS(load_cluster_centers(centers, k=2, size=16), cluster_size=3, batch=4, device="cpu")
    assert got == f"intra-LPIPS: {il.compute(first, rng=np.random.default_rng(3)):.6f}"


@pytest.mark.parametrize("argv", [["fid", "a.npy", "b.npy"], ["kid", "a.npy", "b.npy"],
                                  ["precision_recall", "a.npy", "b.npy"],
                                  ["intra_lpips", "compute", "a.npy", "centers"]])
def test_clis_raise_without_a_card(argv, tmp_path):
    """By default each CLI runs on the card; here, with none, it raises
    before it reads any input (the paths do not exist)."""
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        CLIS[argv[0]][0].main(argv[1:])
