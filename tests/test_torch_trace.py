"""The program's spans and counters (`rick_tpu_torch/utils/trace.py`) on the
CPU: off, they cost no clock read and no `record_function`; under a
profiler, the training phases, the Fisher round, the loader and the
evaluator's generation and Inception land in its trace as annotations; in
`recording()`, the loader's index upload and the kernel wrappers are
counted; the train CLI's `--profile_dir` window carries the spans and is
written when the loop ends inside it; and every span and counter name of the
package is in PERF.md's table."""

import ast
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from rick_tpu_torch import ops
from rick_tpu_torch.cli import train as cli_train
from rick_tpu_torch.data import device_data_stream
from rick_tpu_torch.metrics import Evaluator
from rick_tpu_torch.nn import DiscriminatorConfig, Generator3, Generator3Config, GeneratorConfig
from rick_tpu_torch.train import TrainConfig, fisher_round, init_train_state, run_iteration
from rick_tpu_torch.utils import ProfilerHook, trace
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "rick_tpu_torch"
SIZE = 16
PHASES = ["train.d", "train.r1", "train.g", "train.path"]


@pytest.fixture(scope="module")
def state():
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=0, d_reg_every=2, g_reg_every=2)
    st = init_train_state(GeneratorConfig(size=SIZE), DiscriminatorConfig(size=SIZE), tcfg,
                          rng=torch.Generator().manual_seed(0), device="cpu")
    return st, tcfg


def _iteration(st, tcfg, i=0):
    real = torch.randn((2, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(i))
    return run_iteration(st, tcfg, real, i, gen=torch.Generator().manual_seed(100 + i))


def _annotations(prof, tmp_path):
    """The trace's user annotations, (name, start us, end us), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _read_annotations(path)


def _read_annotations(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda x: x[1])


def _names(annotations, prefix=""):
    return [n for n, _, _ in annotations if n.startswith(prefix)]


def test_off_is_one_shared_object_with_no_clock_and_no_record_function(state, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("train.d") is trace.span("eval.score") is trace.OFF
    assert trace.count("ops.fused_bias_act") is trace.OFF

    def boom(*_):
        raise AssertionError("the recorder was touched while off")

    monkeypatch.setattr(trace, "_clock", boom)
    monkeypatch.setattr(trace, "record_function", boom)
    metrics = _iteration(*state)
    assert all(math.isfinite(float(v)) for v in metrics.values())


def test_phase_spans_nest_in_the_iteration_in_order(state, tmp_path):
    st, tcfg = state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _iteration(st, tcfg, 2)  # every phase fires at 2
    ann = _annotations(prof, tmp_path)
    (it,) = [a for a in ann if a[0] == "train.iteration"]
    phases = [a for a in ann if a[0] in PHASES]
    assert [a[0] for a in phases] == PHASES
    assert all(it[1] <= a[1] and a[2] <= it[2] for a in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_an_iteration_without_regularizers_has_only_d_and_g(state, tmp_path):
    st, tcfg = state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _iteration(st, tcfg, 3)
    assert _names(_annotations(prof, tmp_path), "train.") == ["train.iteration", "train.d", "train.g"]


def test_fisher_round_span(state, tmp_path):
    st, _ = state
    gen = torch.Generator().manual_seed(0)
    noises, reals = torch.randn((2, 512), generator=gen), torch.randn((2, 3, SIZE, SIZE), generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fisher_round(st.g_ema, st.d_ema, noises, reals, batch=2, fisher_quantile=40.0, prune_quantile=10.0,
                     const_noise=True)
    assert _names(_annotations(prof, tmp_path), "fisher.") == ["fisher.round"]


def test_evaluator_spans_per_chunk(state, tmp_path):
    st, _ = state
    real = np.random.default_rng(0).integers(0, 256, (8, 3, SIZE, SIZE), dtype=np.uint8)
    ev = Evaluator(GeneratorConfig(size=SIZE), fid_real_samples=real, inception_nsamples=8, batch_size=8,
                   gen_batch=4, seed=1, device="cpu", inception_stop_at="Mixed_5b", inception_resize_to=75)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        score = ev.compute_inception_score(st.g_ema)
    assert math.isfinite(score["fid"])
    ann = _annotations(prof, tmp_path)
    assert _names(ann, "eval.") == ["eval.score"] + ["eval.generate", "eval.inception"] * 2
    (outer,) = [a for a in ann if a[0] == "eval.score"]
    assert all(outer[1] <= a[1] and a[2] <= outer[2] for a in ann if a[0].startswith("eval."))


def test_stylegan3_spans_inside_generate(tmp_path):
    """StyleGAN3's layer spans open inside `eval.generate`: per chunk one
    `sg3.input`, and one `sg3.modconv` and one `sg3.filtered_lrelu` per
    layer (14 and ToRGB), in turn."""
    cfg = Generator3Config(size=32, channel_base=512, channel_max=16)
    g = Generator3(cfg, rng=torch.Generator().manual_seed(0))
    real = np.random.default_rng(0).integers(0, 256, (4, 3, 32, 32), dtype=np.uint8)
    ev = Evaluator(cfg, fid_real_samples=real, inception_nsamples=4, batch_size=4, gen_batch=2, seed=1, device="cpu",
                   inception_stop_at="Mixed_5b", inception_resize_to=75)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.compute_inception_score(g)
    ann = _annotations(prof, tmp_path)
    chunk = ["eval.generate", "sg3.input"] + ["sg3.modconv", "sg3.filtered_lrelu"] * 15 + ["eval.inception"]
    assert [n for n in _names(ann) if n.startswith(("eval.", "sg3."))] == ["eval.score"] + chunk * 2
    generate = [a for a in ann if a[0] == "eval.generate"]
    for name, start, end in ann:
        if name.startswith("sg3."):
            assert any(s <= start and end <= e for _, s, e in generate), name


def test_filtered_lrelu_counts_its_calls():
    g = Generator3(Generator3Config(size=32, channel_base=512, channel_max=16), rng=torch.Generator().manual_seed(0))
    with trace.recording():
        with torch.inference_mode():
            g([torch.randn((2, 512))])
            g([torch.randn((2, 512))], fast=True)
        got = trace.counters()
    # 15 in the plain pass; ToRGB's in the fast pass, whose 14 filtered layers
    # take K7's wrapper (its plain version on the CPU)
    assert got["ops.filtered_lrelu"][0] == 16 and got["ops.filtered_lrelu"][1] > 0
    assert got["ops.filtered_lrelu_act"][0] == 14 and got["ops.filtered_lrelu_act"][1] > 0
    assert got["ops.modconv_act"][0] == 14  # the fast pass's 3x3 convs (K6's plain version on the CPU)


class _Images:
    """A dataset of seeded images, as `device_data_stream` reads one."""

    flip = True

    def __len__(self):
        return 6

    def get(self, i, rng):
        return np.full((3, SIZE, SIZE), i / 6, np.float32)


def test_loader_counts_one_index_upload_per_batch(tmp_path):
    stream = device_data_stream(_Images(), 2, device="cpu")
    with trace.recording():
        batches = [next(stream) for _ in range(5)]
        got = trace.counters()
    assert [b.shape for b in batches] == [(2, 3, SIZE, SIZE)] * 5
    assert set(got) == {"data.index_upload"}
    calls, ns = got["data.index_upload"]
    assert calls == 5 and ns > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        next(stream)
    assert _names(_annotations(prof, tmp_path), "data.") == ["data.next_batch"]


def test_kernel_wrappers_count_their_cpu_calls():
    gen = torch.Generator().manual_seed(0)
    x, b = torch.randn((2, 4, 8, 8), generator=gen), torch.randn((4,), generator=gen)
    noise, nw, demod = torch.randn((2, 1, 8, 8), generator=gen), torch.ones(1), torch.ones((2, 4))
    xs, w = torch.randn((1, 4, 4, 4), generator=gen), torch.randn((4, 4, 3, 3), generator=gen)
    with trace.recording():
        for _ in range(3):
            ops.fused_bias_act(x, b)
        ops.fused_bias_act_bwd(x, x)
        ops.modconv_epilogue(x, demod, noise, nw, b)
        ops.convt_blur_act(xs, w, torch.ones((1, 4)), torch.zeros((1, 1, 8, 8)), b)
        got = trace.counters()
    assert {k: calls for k, (calls, _) in got.items()} == {
        "ops.fused_bias_act": 3, "ops.fused_bias_act_bwd": 1, "ops.modconv_epilogue": 1, "ops.convt_blur_act": 1}
    assert all(ns > 0 for _, ns in got.values())
    # off again: nothing more is counted, and the last recording's counters stay
    ops.fused_bias_act(x, b)
    assert trace.counters() == got


def test_recording_starts_from_zero_and_turns_spans_on():
    with trace.recording():
        with trace.count("ops.fused_bias_act"):
            pass
        assert trace.span("train.d") is not trace.OFF
    with trace.recording():
        assert trace.counters() == {}
    assert trace.span("train.d") is trace.OFF and trace.count("ops.fused_bias_act") is trace.OFF


def test_profiler_hook_writes_at_its_stop(state, tmp_path):
    st, tcfg = state
    hook = ProfilerHook(str(tmp_path / "prof"), start_iter=4, num_iters=1)
    for i in range(4, 6):
        hook.step(i)
        if i == 4:
            _iteration(st, tcfg, i)
    hook.close(6)  # the window is closed already: nothing more is written
    assert sorted(os.listdir(tmp_path / "prof")) == ["counters_4_5.json", "trace_4_5.json"]
    ann = _read_annotations(tmp_path / "prof" / "trace_4_5.json")
    assert _names(ann, "train.") == ["train.iteration"] + PHASES
    assert trace.span("train.d") is trace.OFF


def test_cli_profile_window_cut_by_the_loops_end(tmp_path):
    """`--iter 0` runs iterations 0-10; with warmup 8 the window starts at
    10 and would stop at 15, so the loop's end writes it."""
    chip_smoke.write_synthetic_store(str(tmp_path), SIZE, 10, 2)
    flags = chip_smoke.cli_flags(str(tmp_path)) + ["--allow_random_fisher_noise", "--profile_dir",
                                                   str(tmp_path / "prof")]
    for k, v in dict(size=SIZE, batch=2, n_sample_train=10, num_fisher_img=2, warmup_iter=8, fisher_freq=8,
                     iter=0).items():
        flags += [f"--{k}", str(v)]
    done = cli_train.main(flags, device="cpu")
    assert done["iterations"] == 11
    assert sorted(os.listdir(tmp_path / "prof")) == ["counters_10_11.json", "trace_10_11.json"]
    ann = _read_annotations(tmp_path / "prof" / "trace_10_11.json")
    # iteration 10: D and G alone (R1 every 16, path every 4)
    assert _names(ann, "train.") == ["train.iteration", "train.d", "train.g"]
    assert "data.next_batch" in _names(ann)
    counters = json.loads((tmp_path / "prof" / "counters_10_11.json").read_text())
    assert counters["data.index_upload"]["calls"] == 1
    assert counters["ops.fused_bias_act"]["calls"] > 0


def _literals():
    """Every name given to `span(...)` or `count(...)` in the package."""
    out = {}
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        imported = {a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                    and node.module == "rick_tpu_torch.utils.trace" for a in node.names}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in {"span", "count"}
                    and node.func.id in imported):
                assert isinstance(node.args[0], ast.Constant), f"{path}:{node.lineno}: a name that is not a literal"
                out[node.args[0].value] = f"{path.relative_to(REPO)}:{node.lineno}"
    return out


def test_every_span_and_counter_is_in_perf_md():
    names = _literals()
    assert set(names) >= {"train.iteration", *PHASES, "fisher.round", "data.next_batch", "data.index_upload",
                          "eval.score", "eval.generate", "eval.inception", "ops.fused_bias_act",
                          "ops.fused_bias_act_bwd", "ops.modconv_epilogue", "ops.convt_blur_act",
                          "ops.modconv_act", "ops.filtered_lrelu", "ops.filtered_lrelu_act", "sg3.input", "sg3.modconv",
                          "sg3.filtered_lrelu"}
    perf = (REPO / "PERF.md").read_text()
    missing = {n: where for n, where in names.items() if f"`{n}`" not in perf}
    assert not missing, f"not named in PERF.md's table of spans and counters: {missing}"
