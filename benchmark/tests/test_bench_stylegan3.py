"""The StyleGAN3-T configuration's parts: its reference's filters against
scipy's, its weights and FLOP count, a CPU FID cell of the architecture at
32px run to `correct` and each evaluation fault planted in it not correct
under the real cell's limits, and the two readers of its layer spans on a
hand-made capture."""

import json

import numpy as np
import pytest
import scipy.signal
import torch

import bench_tiny
from benchmark import control, faults, harness, inputs, spec
from benchmark.reference import stylegan3
from benchmark.trace import Capture

CELL, CONFIG = "sg3t-ffhqu256-fid5k", "stylegan3-t-ffhqu256"
TINY = "tiny-sg3.fid"
MS = 1_000_000  # ns


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The real configuration at 32px (channel_base 512, channel_max 32:
    every kind of layer), on the tiny evaluation of `bench_tiny`, held to
    the real cell's limits."""
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("bench")
    bench = bench_tiny.make(root)
    cfg = dict(spec.config(CONFIG), name="tiny-sg3", size=32, channel_base=512, channel_max=32, d_size=32)
    (root / "configs" / "tiny-sg3.json").write_text(json.dumps(cfg))
    (root / "flops" / f"tiny-sg3.{bench_tiny.FID}.json").write_text(json.dumps({"evaluation": 1}))
    (root / "limits" / f"{TINY}.json").write_text((spec.ROOT / "limits" / f"{CELL}.json").read_text())
    bench["workloads"].append({"name": TINY, "config": "tiny-sg3", "traffic": bench_tiny.FID, "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    return root, bench


def test_reference_filters_are_scipy_firwin():
    """Each layer's filters against scipy's design from NVlabs' schedule
    (written out here): 1e-7 of the largest tap (the same float64 design
    rounded to f32)."""
    cfg = spec.config(CONFIG)
    g, _ = stylegan3.models(cfg, "cpu")
    n, res = cfg["synthesis_layers"], cfg["size"]
    exponents = np.minimum(np.arange(n + 1) / (n - cfg["num_critical"]), 1)
    cutoffs = 2.0 * (res / 2 / 2.0) ** exponents
    stopbands = 2**2.1 * (res / 2 * 2**0.3 / 2**2.1) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    checked = 0
    for idx, name in enumerate(g.synthesis.layer_names[:-1]):
        layer, prev = getattr(g.synthesis, name), max(idx - 1, 0)
        tmp = max(rates[prev], rates[idx]) * 2
        for f, taps, i in ((layer.up_filter, layer.up_taps, prev), (layer.down_filter, layer.down_taps, idx)):
            want = scipy.signal.firwin(taps, cutoffs[i], width=half_widths[i] * 2, fs=tmp)
            assert f.shape == (taps,) and np.abs(f.numpy() - want).max() <= 1e-7 * np.abs(want).max()
            checked += 1
    last = getattr(g.synthesis, g.synthesis.layer_names[-1])
    assert checked == 28 and last.up_filter is None and last.down_filter is None  # ToRGB has none


def test_weights_and_flops_of_the_configuration():
    cfg = spec.config(CONFIG)
    gw, dw = inputs.gan_weights(cfg, 2**31 + 99, "cpu")
    assert gw["synthesis.L7_148_362.weight"].shape == (362, 512, 3, 3) and "synthesis.L14_256_3.bias" in gw
    assert not any(k.endswith(("filter", "transform")) for k in gw)
    assert float(gw["synthesis.input.affine.bias"].min()) > 0.5 and float(gw["synthesis.L3_52_512.magnitude_ema"]) > 0
    assert dw["convs.0.0.weight"].shape == (64, 3, 1, 1)  # D at channel_multiplier 1
    counted = json.loads((spec.ROOT / "flops" / f"{CONFIG}.fid5k.json").read_text())["evaluation"]
    convs = 210_056_547_840  # the 14 3x3 convs and ToRGB per image, 2 x Cin x Cout x taps x (in side + 2)^2
    assert 5000 * convs < counted < 5000 * convs * 1.25  # + the FIR passes, the input, the mapping, Inception


def test_tiny_cell_is_correct_and_faults_are_not(tiny):
    root, bench = tiny
    ctx = harness.make_ctx(TINY, 2**31 + 12345, False, "cpu", bench, root)
    assert spec.arch(ctx.cfg) == "stylegan3"
    res = harness.run(ctx, 0.5)
    assert res["correct"] is True and res["attempted"] > 0, res["checks"]
    assert set(res["metrics"]) == {"setup_s", "fid5k_s"}
    for fault in faults.EVAL:
        got = control.readings(TINY, 7, False, 0.2, [fault], control=False, device="cpu", bench=bench, root=root)
        assert not harness.judge(got[f"fault:{fault}"], ctx.limits), (fault, got)


def _capture():
    """One chunk of generation: `eval.generate` holding the input, two
    layers' modconv and filtered leaky ReLU spans, then Inception."""
    spans = [("eval.score", 0, 100 * MS), ("eval.generate", 1 * MS, 60 * MS), ("sg3.input", 2 * MS, 5 * MS),
             ("sg3.modconv", 6 * MS, 10 * MS), ("sg3.filtered_lrelu", 10 * MS, 30 * MS),
             ("sg3.modconv", 31 * MS, 35 * MS), ("sg3.filtered_lrelu", 35 * MS, 58 * MS),
             ("eval.inception", 60 * MS, 90 * MS)]
    # (launch ms, record, device start ms, device ms)
    work = [(3, "sin", 4, 1.0), (7, "modconv_act_kernel", 8, 6.0), (12, "conv_fir", 15, 9.0), (20, "lrelu", 25, 3.0),
            (32, "modconv_act_kernel", 33, 4.0), (40, "conv_fir", 41, 11.0), (59, "mean", 60, 0.5),
            (70, "inception_fprop", 71, 15.0)]
    host, device = [], []
    for launch, name, start, dur in work:
        host.append(("cudaLaunchKernel", int(launch * MS), int(launch * MS) + 5000))
        device.append((name, int(start * MS), int((start + dur) * MS)))
    return Capture(window_s=0.1, t0_ns=0, t1_ns=100 * MS, device=device, host=host, spans=spans, kernels=device)


def _read(name, cap):
    win = harness.Window(seconds=2.0, units=1, capture=cap, traced_work={"evaluation": 1} if cap else {})
    return spec.metric_reader(name).read(harness.Record(win, {}))


def test_layer_span_readers():
    cap = _capture()
    assert _read("flrelu_device_ms.eval", cap) == pytest.approx(9.0 + 3.0 + 11.0)
    assert _read("sg3_conv_device_ms.eval", cap) == pytest.approx(6.0 + 4.0)
    # generation keeps all of its device time, the layer spans' too
    assert _read("gen_device_ms.eval", cap) == pytest.approx(1.0 + 6.0 + 9.0 + 3.0 + 4.0 + 11.0 + 0.5)
    # a program without the layer spans (StyleGAN2, or the parent commit) gives nothing, and does not raise
    plain = Capture(window_s=cap.window_s, t0_ns=0, t1_ns=cap.t1_ns, device=cap.device, host=cap.host,
                    spans=[s for s in cap.spans if not s[0].startswith("sg3.")], kernels=cap.kernels)
    assert _read("flrelu_device_ms.eval", plain) is None and _read("sg3_conv_device_ms.eval", plain) is None
    assert _read("flrelu_device_ms.eval", None) is None
