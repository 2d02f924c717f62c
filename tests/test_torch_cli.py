"""The port's train CLI: its flags against `rick_tpu.cli.train`'s, the
flags it refuses, a first run and its --auto_resume run on the CPU at 16px
checked as `chip_smoke.py` phase 14 checks the 256px runs on the card, a run
with ADA, and the dataset-level files it shares with `rick_tpu` (the
few-shot index, the real-images cache) against `rick_tpu`'s own."""

import argparse
import json
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
import rick_tpu.cli.train as j_train
import rick_tpu.metrics
import rick_tpu.train
from rick_tpu_torch.cli import train
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

SIZE = 16


def _spec(parser: argparse.ArgumentParser):
    return {
        tuple(a.option_strings): (a.dest, a.type, a.default, a.nargs, a.const, a.required, type(a).__name__)
        for a in parser._actions
    }


def test_flags_are_rick_tpus():
    """The same option strings, dests, types, defaults and actions."""
    assert _spec(train.build_parser()) == _spec(j_train.build_parser())


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["WORLD_SIZE=2"]])
def test_unported_flags_raise_before_any_work(flags, tmp_path, monkeypatch):
    """Multi-GPU runs are ported (tests/test_torch_dist_cli.py runs 2
    ranks); what still raises before any work is a `--n_devices` that is
    neither 0 nor the launch's world size: 2 in a single process, and 3 in
    a launch of WORLD_SIZE=2."""
    for v in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    if flags == ["WORLD_SIZE=2"]:
        monkeypatch.setenv("WORLD_SIZE", "2")
        flags = ["--n_devices", "3"]
    with pytest.raises(ValueError, match="torchrun"):
        train.main(flags + ["--output_root", str(tmp_path / "out")], device="cpu")
    assert not (tmp_path / "out").exists()


def _flags(root, **over):
    flags = dict(
        size=SIZE, batch=2, n_sample_train=10, num_fisher_img=2, fisher_quantile=40, prune_quantile=0.1,
        warmup_iter=2, fisher_freq=8, eval_in_training_freq=10, samples_freq=5, checkpoints_freq=8,
        n_sample_test=4, n_sample_store=4,
    )
    flags.update(over)
    out = chip_smoke.cli_flags(str(root)) + ["--allow_random_fisher_noise", "--eval_in_training", "--store_samples",
                                             "--store_checkpoints"]
    for k, v in flags.items():
        out += [f"--{k}", str(v)]
    return out


def test_cli_runs_and_resumes_on_the_cpu(tmp_path):
    """A first run (iterations 0-10) and an --auto_resume run that resumes
    at the checkpoint of 8 and runs 8-12, checked as phase 14 checks them:
    stats, best FID, PNGs, the .pt against the .state.npz, a bitwise
    re-save of the .state.npz the resumed run wrote."""
    chip_smoke.write_synthetic_store(str(tmp_path), SIZE, 10, 6)
    first = train.main(_flags(tmp_path, iter=0), device="cpu")
    second = train.main(_flags(tmp_path, iter=2) + ["--auto_resume"], device="cpu")
    assert (first["iterations"], first["fisher_rounds"], first["evaluations"]) == (11, 2, 2)
    assert (second["iterations"], second["fisher_rounds"], second["evaluations"]) == (5, 1, 1)
    out = tmp_path / "out" / "cli"
    got = chip_smoke.check_cli_runs(str(out), first, second, size=SIZE, device="cpu", resume_step=8, last_step=8,
                                    eval_steps=(0, 10), sample_steps=(0, 5, 10), n_store=4)
    assert got["ckpt_rel"] == 0.0
    assert "tf32 : False" in (out / "args.txt").read_text()
    assert (out / "train_script.py").read_text() == open(train.__file__).read()


def test_cli_runs_with_ada_on_the_cpu(tmp_path, capsys):
    """--augment at 16px with margin 44 (ada.py's rule for the size) and a
    fixed --augment_p 0.5, so that the warp moves the images: the run
    reaches its end with finite losses and logs its p."""
    chip_smoke.write_synthetic_store(str(tmp_path), SIZE, 10, 4)
    flags = chip_smoke.cli_flags(str(tmp_path)) + [
        "--size", str(SIZE), "--batch", "2", "--num_fisher_img", "2", "--allow_random_fisher_noise",
        "--warmup_iter", "2", "--fisher_freq", "100", "--iter", "0", "--augment", "--augment_p", "0.5",
        "--ada_margin", "44",
    ]
    summary = train.main(flags, device="cpu")
    assert (summary["iterations"], summary["fisher_rounds"]) == (11, 1)
    recs = [json.loads(line) for line in (tmp_path / "out" / "cli" / "stats.jsonl").read_text().splitlines()]
    assert [r["ada_p"] for r in recs] == [0.5]
    assert all(math.isfinite(v) for v in recs[0].values())
    assert "augment: 0.5000" in capsys.readouterr().out


def test_cli_runs_with_bf16_on_the_cpu(tmp_path):
    """--bf16 (the D and G phases' compute dtype) at 16px: the run reaches
    its end with finite losses and records the flag in args.txt."""
    chip_smoke.write_synthetic_store(str(tmp_path), SIZE, 10, 4)
    flags = chip_smoke.cli_flags(str(tmp_path)) + [
        "--size", str(SIZE), "--batch", "2", "--num_fisher_img", "2", "--allow_random_fisher_noise",
        "--warmup_iter", "2", "--fisher_freq", "100", "--iter", "0", "--bf16",
    ]
    summary = train.main(flags, device="cpu")
    assert (summary["iterations"], summary["fisher_rounds"]) == (11, 1)
    recs = [json.loads(line) for line in (tmp_path / "out" / "cli" / "stats.jsonl").read_text().splitlines()]
    assert recs and all(math.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))
    assert "bf16 : True" in (tmp_path / "out" / "cli" / "args.txt").read_text().splitlines()


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


def test_few_shot_index_and_real_images_cache_are_rick_tpus(tmp_path, monkeypatch):
    """Both CLIs run to their Evaluator on one store with --n_sample_train 5:
    the index files and the uint8 real-images caches are the same bytes,
    under the same cache name; the activation caches' names differ."""
    chip_smoke.write_synthetic_store(str(tmp_path), SIZE, 10, 12)
    monkeypatch.setattr(train, "Evaluator", _stop)
    monkeypatch.setattr(rick_tpu.metrics, "Evaluator", _stop)
    monkeypatch.setattr(rick_tpu.train, "make_train_step", lambda *a, **k: None)
    monkeypatch.setenv("RICK_NO_XLA_CACHE", "1")
    flags = _flags(tmp_path, n_sample_train=5, n_sample_test=7)
    cache = tmp_path / "_cache"
    with pytest.raises(_Stop):
        train.main(flags + ["--exp", "port"], device="cpu")
    (port_imgs,) = list(cache.glob("real_imgs_*.npy"))
    port_bytes = port_imgs.read_bytes()
    port_imgs.unlink()
    with pytest.raises(_Stop):
        j_train.main(flags + ["--exp", "jax"])
    (jax_imgs,) = list(cache.glob("real_imgs_*.npy"))
    assert jax_imgs.name == port_imgs.name
    assert jax_imgs.read_bytes() == port_bytes
    assert np.load(jax_imgs).shape == (7, 3, SIZE, SIZE)
    index = "5-shot-index.txt"
    assert (tmp_path / "out" / "port" / index).read_bytes() == (tmp_path / "out" / "jax" / index).read_bytes()

    args = train.build_parser().parse_args(flags)
    test_path = os.path.join(str(tmp_path), "_processed_test", args.data_path)
    port_paths = train._real_cache_paths(args, test_path, str(cache))
    jax_paths = j_train._real_cache_paths(j_train.build_parser().parse_args(flags), test_path, str(cache))
    assert port_paths[0] == jax_paths[0] and port_paths[1] != jax_paths[1]
    assert os.path.basename(port_paths[1]).startswith(os.path.basename(jax_paths[1])[: -len(".npy")])


def test_iteration_draws_depend_on_seed_iteration_and_tag_only():
    """A resumed run draws at iteration i what a continuous run draws."""
    def draw(seed, i, tag):
        return torch.randn(8, generator=train.iteration_generator("cpu", seed, i, tag))

    assert torch.equal(draw(1, 15, train.PHASES_TAG), draw(1, 15, train.PHASES_TAG))
    others = [draw(2, 15, train.PHASES_TAG), draw(1, 16, train.PHASES_TAG), draw(1, 15, train.FISHER_TAG)]
    assert not any(torch.equal(draw(1, 15, train.PHASES_TAG), o) for o in others)


def test_fisher_noises_read_the_fixtures_and_refuse_what_is_missing(tmp_path):
    torch.save(torch.arange(2 * 512, dtype=torch.float32).reshape(2, 512), tmp_path / "0000.pt")
    with pytest.raises(FileNotFoundError, match="allow_random_fisher_noise"):
        train.load_fisher_noises(str(tmp_path), 2, 512, 2)
    noises, rows = train.load_fisher_noises(str(tmp_path), 2, 512, 2, allow_random=True)
    assert rows == [2, 1] and noises.shape == (3, 512) and noises.dtype == np.float32
    np.testing.assert_array_equal(noises[:2], np.arange(2 * 512, dtype=np.float32).reshape(2, 512))
    seeded = torch.randn((1, 512), generator=torch.Generator().manual_seed(1001)).numpy()
    np.testing.assert_array_equal(noises[2:], seeded)
    with pytest.raises(ValueError, match="rows > batch"):
        train.load_fisher_noises(str(tmp_path), 1, 512, 1)
