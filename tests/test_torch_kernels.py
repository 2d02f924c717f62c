"""The CUDA kernels' plain versions against the Pallas kernels (interpret mode
on the CPU, as tests/test_pallas.py and tests/test_fused_upsample.py run
them), the wrappers' dispatch and counters, and the import contract.

The kernels themselves are compared with their plain versions on the card by
tests/test_torch_cuda.py."""

import ast
import ctypes
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rick_tpu.ops.fused_upsample import convt_blur_act as j_convt_blur_act
from rick_tpu.ops.fused_upsample import convt_blur_act_ref as j_convt_blur_act_ref
from rick_tpu.ops.pallas_kernels import fused_bias_act_pallas, modconv_epilogue_pallas
from rick_tpu_torch import ops
from rick_tpu_torch.ops import _build
from tests.torch_port_helpers import close, j, n, one_torch_thread, rand, t  # noqa: F401

PACKAGE = Path(__file__).resolve().parent.parent / "rick_tpu_torch"


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16-representable values (the JAX kernel's matmul inputs)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# K1 fused_bias_act
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (4, 32), (3, 5, 7, 9)])
def test_fused_bias_act_ref_matches_pallas(shape):
    x = rand(shape, 0)
    b = rand((shape[-1] if len(shape) == 2 else shape[1],), 1)
    want = fused_bias_act_pallas(j(x), j(b), 0.2, 2.0**0.5, True)
    # elementwise, same operation order: within 1e-6
    close(ops.fused_bias_act_ref(t(x), t(b)), want, rtol=1e-6, atol_frac=1e-6)


# ---------------------------------------------------------------------------
# K3 modconv_epilogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (3, 5, 7, 9)])
@pytest.mark.parametrize("noise_batch", ["B", "1"])
def test_modconv_epilogue_ref_matches_pallas(shape, noise_batch):
    B, C, H, W = shape
    out, bias = rand(shape, 0), rand((C,), 3)
    demod = np.abs(rand((B, C), 1)) + 0.1
    noise = rand((B if noise_batch == "B" else 1, 1, H, W), 2)
    nw = np.float32(0.7)
    got = ops.modconv_epilogue_ref(t(out), t(demod), t(noise), torch.tensor([nw]), t(bias))
    # the Pallas kernel takes per-sample noise only: hand it the broadcast
    noise_b = np.broadcast_to(noise, (B, 1, H, W))
    want = modconv_epilogue_pallas(j(out), j(demod), j(noise_b), jnp.float32(nw), j(bias), 0.2, 2.0**0.5, True)
    # elementwise; the two may contract a multiply-add differently: 1e-6
    close(got, want, rtol=1e-6, atol_frac=1e-6)


# ---------------------------------------------------------------------------
# K4 convt_blur_act
# ---------------------------------------------------------------------------


def _convt_args(N, Cin, Cout, H, noise_batch=None, seed=0, bf16=False):
    xs = rand((N, Cin, H, H), seed)
    w = rand((Cout, Cin, 3, 3), seed + 1, 0.1)
    demod = np.random.default_rng(seed + 2).uniform(0.5, 1.5, (N, Cout)).astype(np.float32)
    noise = rand((N if noise_batch is None else noise_batch, 1, 2 * H, 2 * H), seed + 3, 0.1)
    bias = rand((Cout,), seed + 4, 0.1)
    args = (xs, w, demod, noise, bias)
    return tuple(_bf16(a) for a in args) if bf16 else args


CONVT_CASES = [(2, 8, 8, 8), (1, 16, 8, 4), (3, 8, 16, 16), (1, 8, 256, 8)]


@pytest.mark.parametrize("N,Cin,Cout,H", CONVT_CASES)
def test_convt_blur_act_ref_matches_jax_ref(N, Cin, Cout, H):
    args = _convt_args(N, Cin, Cout, H, seed=N * 100 + H)
    got = ops.convt_blur_act_ref(*map(t, args))
    # both f32 chains (conv_transpose + blur); sums of 9*Cin products: 1e-5
    close(got, j_convt_blur_act_ref(*map(j, args)), rtol=1e-5, atol_frac=1e-5)


def test_convt_blur_act_ref_variants_match_jax_ref():
    xs, w, demod, noise, _ = _convt_args(3, 8, 8, 8, noise_batch=1, seed=7)
    got = ops.convt_blur_act_ref(t(xs), t(w), t(demod), t(noise), None, use_act=False)
    want = j_convt_blur_act_ref(j(xs), j(w), j(demod), j(noise), None, use_act=False)
    close(got, want, rtol=1e-5, atol_frac=1e-5)


@pytest.mark.parametrize("noise_batch", [None, 1], ids=["noise_B", "noise_1"])
def test_convt_blur_act_ref_matches_pallas_interpret(noise_batch):
    args = _convt_args(2, 8, 8, 8, noise_batch=noise_batch, seed=11)
    got = ops.convt_blur_act_ref(*map(t, args))
    want = j_convt_blur_act(*map(j, args), interpret=True)
    # the Pallas kernel rounds its matmul inputs to bf16: 2e-2 of max|ref|
    close(got, want, rtol=0, atol_frac=2e-2)


def test_convt_blur_act_ref_exact_on_bf16_inputs_vs_pallas():
    """On bf16-representable inputs the Pallas kernel's matmuls are exact, so
    the two agree to f32 reassociation."""
    args = _convt_args(1, 16, 8, 4, seed=13, bf16=True)
    got = ops.convt_blur_act_ref(*map(t, args))
    close(got, j_convt_blur_act(*map(j, args), interpret=True), rtol=1e-5, atol_frac=1e-5)


# K4 computes the transposed conv in 3xTF32 on the tensor cores: the plain
# chain on the same split operands holds 1e-5 of max|ref| against the f32
# chains at Cin up to 512, where plain TF32 (hi*hi alone) misses 1e-4; that is
# why the card's checks of K4 stay at 1e-4


def test_tf32_round_is_round_to_nearest_ties_away_on_13_low_bits():
    from rick_tpu_torch.ops.fused_upsample import tf32_round

    x = t([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3 + 2**-9 - 2**-20, 0.0])
    want = [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 3 + 2**-9, 0.0]
    assert tf32_round(x).tolist() == want
    r = tf32_round(t(rand((1000,), 0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("N,Cin,Cout,H", [(1, 512, 32, 8), (1, 512, 16, 16), (2, 64, 16, 8), (1, 256, 8, 16)])
def test_3xtf32_chain_holds_1e5_where_tf32_does_not(N, Cin, Cout, H):
    from rick_tpu_torch.ops.fused_upsample import convt_blur_act_tf32_ref

    args = _convt_args(N, Cin, Cout, H, seed=Cin + H)
    ref = ops.convt_blur_act_ref(*map(t, args))
    three = convt_blur_act_tf32_ref(*map(t, args))
    close(three, ref, rtol=0, atol_frac=1e-5)
    close(three, j_convt_blur_act_ref(*map(j, args)), rtol=0, atol_frac=1e-5)
    one = convt_blur_act_tf32_ref(*map(t, args), passes=1)
    if Cin == 512:
        assert float((one - ref).abs().max()) > 1e-4 * float(ref.abs().max())


def test_ablation_bound_counts_the_conv_as_3xtf32():
    """A stage's bound: the conv's operations x 3 at 495 TFLOP/s, the blur
    and epilogue at 67 TFLOP/s, the bytes at 3.35 TB/s; the largest."""
    from rick_tpu_torch.tools.bench_fused_ablate import stage_bound, stage_work

    b, cin, cout, h = 100, 256, 128, 128
    conv = 2 * b * cin * cout * 9 * h * h
    ms, by = stage_bound("full", b, cin, cout, h)
    assert by == "operations" and ms == pytest.approx(3 * conv / 495e12 * 1e3)
    assert ms == pytest.approx(5.857, abs=1e-3)
    assert stage_bound("load", b, cin, cout, h) == (stage_work("load", b, cin, cout, h)[0] / 3.35e12 * 1e3, "bytes")
    # a wide blur with no conv to speak of is bounded by its f32 operations or its bytes
    nbytes, ops = stage_work("blur", 1, 1, 4096, 64)
    assert stage_bound("blur", 1, 1, 4096, 64)[0] == pytest.approx(
        max(nbytes / 3.35e12, (ops - 2 * 4096 * 9 * 64 * 64) / 67e12, 3 * 2 * 4096 * 9 * 64 * 64 / 495e12) * 1e3)


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 360 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3barPf\n"
        "    8 bytes stack frame, 68 bytes spill stores, 72 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 360 bytes cmem[0]\n"
    )
    got = [{k: v for k, v in r.items() if k != "name"} for r in _build.ptxas_report(log)]
    assert got == [dict(registers=40, spill_stores=0, spill_loads=0),
                   dict(registers=128, spill_stores=68, spill_loads=72)]


# ---------------------------------------------------------------------------
# K6 modconv_act (the plain StyledConv's conv and epilogue, for generation)
# ---------------------------------------------------------------------------


def _modconv_act_args(N, Cin, Cout, H, noise_batch=None, seed=0):
    x = rand((N, Cin, H, H), seed)
    s = rand((N, Cin), seed + 1) + 1.0
    w = rand((Cout, Cin, 3, 3), seed + 2, 1.0 / (9 * Cin) ** 0.5)
    demod = np.random.default_rng(seed + 3).uniform(0.5, 1.5, (N, Cout)).astype(np.float32)
    noise = rand((N if noise_batch is None else noise_batch, 1, H, H), seed + 4)
    nw = np.array([0.3], np.float32)
    bias = rand((Cout,), seed + 5, 0.1)
    return x, s, w, demod, noise, nw, bias


# the 4x4, 8x8 and 16x16 maps take the kernel's three small tiles
MODCONV_ACT_CASES = [(3, 16, 8, 4), (2, 8, 16, 8), (2, 8, 8, 16)]


@pytest.mark.parametrize("N,Cin,Cout,H", MODCONV_ACT_CASES)
@pytest.mark.parametrize("noise_batch", [None, 1], ids=["noise_B", "noise_1"])
def test_modconv_act_ref_matches_the_unfused_chain_and_rick_tpu(N, Cin, Cout, H, noise_batch):
    """K6's plain version is the port's unfused chain (x * s, the conv with
    padding 1, K3's plain version), and the wrapper takes it on the CPU;
    rick_tpu's chain (x * style, XLA's conv, the Pallas epilogue in
    interpret mode) agrees to f32 reassociation."""
    from jax import lax

    x, s, w, demod, noise, nw, bias = args = _modconv_act_args(N, Cin, Cout, H, noise_batch, seed=N * 10 + H)
    got = ops.modconv_act_ref(*map(t, args))
    chain = ops.modconv_epilogue_ref(torch.nn.functional.conv2d(t(x) * t(s)[:, :, None, None], t(w), padding=1),
                                     t(demod), t(noise), t(nw), t(bias))
    assert torch.equal(got, chain)
    assert torch.equal(ops.modconv_act(*map(t, args)), got)
    out = lax.conv_general_dilated(j(x) * j(s)[:, :, None, None], j(w), (1, 1), ((1, 1), (1, 1)),
                                   dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                   precision=lax.Precision.HIGHEST)
    noise_b = np.broadcast_to(noise, (N, 1, H, H))
    want = modconv_epilogue_pallas(out, j(demod), j(noise_b), jnp.float32(nw[0]), j(bias), 0.2, 2.0**0.5, True)
    # sums of 9*Cin products in another order: 1e-5
    close(got, want, rtol=1e-5, atol_frac=1e-5)


def test_modconv_act_kernel_weights_are_blocked_k_major_hi_lo():
    """The kernel's B operand: [co block][4 channels][tap][hi, lo][co][4],
    hi = tf32(w), lo = tf32(w - hi), zero past Cout (padded to 128) and Cin
    (padded to 8)."""
    from rick_tpu_torch.ops.fused_upsample import tf32_round
    from rick_tpu_torch.ops.modconv_act import _kernel_weights

    cout, cin = 130, 12
    w = t(rand((cout, cin, 3, 3), 3))
    wt = _kernel_weights(w)
    assert tuple(wt.shape) == (2, 4, 9, 2, 128, 4)
    for co, ci, ky, kx in [(0, 0, 0, 0), (129, 11, 2, 2), (77, 5, 1, 2), (128, 8, 0, 1)]:
        hi, lo = wt[co // 128, ci // 4, 3 * ky + kx, :, co % 128, ci % 4].reshape(2, 1)
        v = w[co, ci, ky, kx].reshape(1)
        assert torch.equal(hi, tf32_round(v)) and torch.equal(lo, tf32_round(v - hi))
    assert not wt[1, :, :, :, 2:].any() and not wt[:, 3].any()


@pytest.mark.parametrize("N,Cin,Cout,H", [(1, 512, 16, 8), (1, 256, 8, 16)])
def test_3xtf32_modconv_act_chain_holds_1e5_where_tf32_does_not(N, Cin, Cout, H):
    """The kernel's arithmetic in plain PyTorch: x * s rounded once in f32,
    then each operand split as hi = tf32(v), lo = tf32(v - hi) and the conv
    summed as hi*hi + hi*lo + lo*hi: within 1e-5 of max|ref| of the f32
    chain at Cin up to 512, where hi*hi alone (plain TF32) misses 1e-4; why
    the card holds K6 to 1e-4."""
    from rick_tpu_torch.ops.fused_upsample import tf32_round

    x, s, w, demod, noise, nw, bias = map(t, _modconv_act_args(N, Cin, Cout, H, seed=Cin + H))
    ref = ops.modconv_act_ref(x, s, w, demod, noise, nw, bias)
    xs = x * s[:, :, None, None]
    x_hi, w_hi = tf32_round(xs), tf32_round(w)
    pairs = [(x_hi, w_hi), (x_hi, tf32_round(w - w_hi)), (tf32_round(xs - x_hi), w_hi)]

    def chain(pairs):
        out = sum(torch.nn.functional.conv2d(a, b, padding=1) for a, b in pairs)
        return ops.modconv_epilogue_ref(out, demod, noise, nw, bias)

    close(chain(pairs), ref, rtol=0, atol_frac=1e-5)
    if Cin == 512:
        assert float((chain(pairs[:1]) - ref).abs().max()) > 1e-4 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# K5 convt_blur_act_stage (K4 cut after each stage)
# ---------------------------------------------------------------------------


def _stage_want(stage, xs, w, demod, noise, bias):
    """Each stage's function from rick_tpu's pieces: zeros, the transposed
    conv of `convt_blur_act_ref` (`lax.conv_general_dilated`) cropped to
    (2H, 2W), the chain with demod 1, zero noise, no bias and no activation,
    and the chain itself."""
    from jax import lax

    N, _, H, W = xs.shape
    if stage == "load":
        return np.zeros((N, w.shape[0], 2 * H, 2 * W), np.float32)
    if stage == "conv":
        out = lax.conv_general_dilated(j(xs), jnp.flip(j(w), (2, 3)), (1, 1), ((2, 2), (2, 2)), lhs_dilation=(2, 2),
                                       dimension_numbers=("NCHW", "OIHW", "NCHW"))
        return np.asarray(out)[..., : 2 * H, : 2 * W]
    if stage == "blur":
        ones, zeros = np.ones_like(demod), np.zeros((1, 1, 2 * H, 2 * W), np.float32)
        return j_convt_blur_act_ref(j(xs), j(w), j(ones), j(zeros), None, use_act=False)
    return j_convt_blur_act_ref(j(xs), j(w), j(demod), j(noise), j(bias))


@pytest.mark.parametrize("stage", ops.STAGES)
@pytest.mark.parametrize("N,Cin,Cout,H", [(2, 8, 8, 4), (1, 16, 4, 8)])
def test_convt_blur_act_stage_ref_matches_jax_pieces(stage, N, Cin, Cout, H):
    args = _convt_args(N, Cin, Cout, H, seed=N * 10 + H)
    got = ops.convt_blur_act_stage_ref(stage, *map(t, args))
    want = _stage_want(stage, *args)
    assert got.shape == (N, Cout, 2 * H, 2 * H)
    if stage == "load":
        assert not got.any()
    else:  # f32 chains; sums of 9*Cin products in another order: 1e-5
        close(got, want, rtol=1e-5, atol_frac=1e-5)


def test_convt_blur_act_stage_dispatch_and_counts():
    args = tuple(map(t, _convt_args(1, 4, 4, 3)))
    ops.reset_launch_counts()
    for stage in ops.STAGES:
        assert torch.equal(ops.convt_blur_act_stage(stage, *args), ops.convt_blur_act_stage_ref(stage, *args))
    assert torch.equal(ops.convt_blur_act_stage("full", *args), ops.convt_blur_act(*args))
    assert ops.convt_blur_act_stage.launches == dict.fromkeys(ops.STAGES, 0)
    with pytest.raises(ValueError, match="stage"):
        ops.convt_blur_act_stage("epilogue", *args)
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.convt_blur_act_stage("conv", *meta)


def test_ablation_check_passes_the_plain_stages_and_catches_a_wrong_one(monkeypatch):
    """On the CPU every stage is its plain version, so the ablation's check
    passes with zero error; a stage that is off by more than its tolerance,
    or a load stage that writes anything, raises."""
    from rick_tpu_torch.tools import bench_fused_ablate as bfa

    assert bfa.verify(2, ((8, 4, 4), (16, 8, 2)), "cpu") == dict.fromkeys(ops.STAGES, 0.0)
    args = bfa.make_inputs(8, 4, 4, 2, "cpu")
    plain = ops.convt_blur_act_stage_ref
    for broken in ("load", "conv", "blur", "full"):
        def off(stage, *a, broken=broken, **kw):
            y = plain(stage, *a, **kw)
            return y + 1e-3 * y.abs().max() + (stage == "load") if stage == broken else y

        monkeypatch.setattr(bfa, "convt_blur_act_stage", off)
        with pytest.raises(RuntimeError, match=f"K5 {broken}"):
            bfa.check_stages(args)


def test_ablation_work_counts_the_separable_blur():
    """Bytes and operations of each stage: the transposed conv's MACs, 16
    operations per output for the separable 4-tap blur, 4 for the epilogue."""
    from rick_tpu_torch.tools.bench_fused_ablate import stage_work

    b, cin, cout, h = 2, 8, 4, 3
    y, conv = b * cout * 4 * h * h, 2 * b * cin * cout * 9 * h * h
    base = 4 * (b * cin * h * h + cout * cin * 9 + y)
    assert stage_work("load", b, cin, cout, h) == (base, 0)
    assert stage_work("conv", b, cin, cout, h) == (base, conv)
    assert stage_work("blur", b, cin, cout, h) == (base, conv + 16 * y)
    assert stage_work("full", b, cin, cout, h) == (base + 4 * (b * cout + b * 4 * h * h + cout), conv + 20 * y)


def test_blur_taps_are_flipped_normalized_gain_two():
    from rick_tpu_torch.ops.fused_upsample import blur_taps

    np.testing.assert_allclose(blur_taps((1, 3, 3, 1)), [0.25, 0.75, 0.75, 0.25])
    np.testing.assert_allclose(blur_taps((1, 2, 3, 4)), [0.8, 0.6, 0.4, 0.2])


# ---------------------------------------------------------------------------
# dispatch, counters, validation
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    ops.reset_launch_counts()
    x, b = t(rand((2, 4, 3, 3), 0)), t(rand((4,), 1))
    assert torch.equal(ops.fused_bias_act(x, b), ops.fused_bias_act_ref(x, b))
    demod, noise, nw = t(np.abs(rand((2, 4), 2))), t(rand((1, 1, 3, 3), 3)), torch.tensor([0.5])
    assert torch.equal(ops.modconv_epilogue(x, demod, noise, nw, b), ops.modconv_epilogue_ref(x, demod, noise, nw, b))
    args = tuple(map(t, _convt_args(1, 4, 4, 3)))
    assert torch.equal(ops.convt_blur_act(*args), ops.convt_blur_act_ref(*args))
    g = t(rand((2, 4, 3, 3), 4))
    assert torch.equal(ops.fused_bias_act_bwd(g, x, b), ops.fused_bias_act_bwd_ref(g, x, b))
    k6 = tuple(map(t, _modconv_act_args(2, 4, 4, 3)))
    assert torch.equal(ops.modconv_act(*k6), ops.modconv_act_ref(*k6))
    fu, fd = t(rand((12,), 5)), t(rand((12,), 6))
    xf = t(rand((2, 4, 13, 13), 7))
    assert torch.equal(ops.filtered_lrelu_act(xf, fu, fd, b, up=2, down=2, padding=(9, 8, 9, 8)),
                       ops.filtered_lrelu_ref(xf, fu, fd, b, up=2, down=2, padding=(9, 8, 9, 8)))
    assert ops.launch_counts() == {
        "fused_bias_act": 0, "fused_bias_act_bwd": 0, "modconv_epilogue": 0, "convt_blur_act": 0, "modconv_act": 0,
        "filtered_lrelu_act": 0,
    }


def test_bf16_wrappers_take_plain_version_on_cpu_and_count_nothing():
    """K1-bf16 and K3-bf16 on CPU tensors: the plain versions (f32 out of
    bf16 in), no launch counted in either form."""
    ops.reset_launch_counts()
    x, b = t(rand((2, 4, 3, 3), 0)).bfloat16(), t(rand((4,), 1))
    y = ops.fused_bias_act(x, b)
    assert y.dtype == torch.float32 and torch.equal(y, ops.fused_bias_act_ref(x, b))
    epi = (x, t(np.abs(rand((2, 4), 2))).bfloat16(), t(rand((1, 1, 3, 3), 3)).bfloat16(),
           torch.tensor([0.5]).bfloat16(), b)
    y = ops.modconv_epilogue(*epi)
    assert y.dtype == torch.float32 and torch.equal(y, ops.modconv_epilogue_ref(*epi))
    assert ops.bf16_launch_counts() == {"fused_bias_act_bf16": 0, "modconv_epilogue_bf16": 0}
    assert set(ops.launch_counts().values()) == {0}


# K1's, K3's and K4's byte and operation counts at main-path shapes, and the
# bound each gave before the launch floor was counted: (ms, by)
ROOFLINE_CASES = {
    "K1 (4,128,256,256)": (4 * (2 * 4 * 128 * 256 * 256 + 128), 3 * 4 * 128 * 256 * 256, 0.0),
    "K1-bf16 (2,128,256,256)": (None, 3 * 2 * 128 * 256 * 256, 0.0),
    "K3-bf16 (2,512,4,4)": (None, 6 * 2 * 512 * 16, 0.0),
    "K4 (4,256,128,128)->128": (4 * (4 * 256 * 128 * 128 + 128 * 256 * 9 + 4 * 128 + 4 * 256 * 256 + 128
                                     + 4 * 128 * 256 * 256), 20 * 4 * 128 * 256 * 256, None),
    "K6 (100,128,256,256)": (4 * (100 * 128 * 256 * 256 + 100 * 128 + 128 * 128 * 9 + 100 * 128 + 100 * 256 * 256
                                  + 1 + 128 + 100 * 128 * 256 * 256), 4 * 100 * 128 * 256 * 256,
                             3 * 2 * 100 * 128 * 128 * 9 * 256 * 256),
}


def _roofline_case(key):
    from rick_tpu_torch.tools import roofline

    nbytes, f32_ops, tf32_ops = ROOFLINE_CASES[key]
    if key.startswith("K1-bf16"):
        nbytes = roofline.fused_bias_act_bytes(2 * 128 * 256 * 256, 128, 2)
    elif key.startswith("K3-bf16"):
        nbytes = roofline.modconv_epilogue_bytes(2, 512, 16, 2, 2)
    if tf32_ops is None:
        tf32_ops = roofline.TF32_PASSES * roofline.convt_ops(4, 256, 128, 128)
    if key.startswith("K6"):
        assert roofline.modconv_act_work(100, 128, 128, 256, 256, 100) == (nbytes, f32_ops, tf32_ops)
    return nbytes, f32_ops, tf32_ops


@pytest.mark.parametrize("key", list(ROOFLINE_CASES))
def test_roofline_bound_without_a_launch_floor_is_unchanged(key):
    """Called without `launch_ms` (or with 0), `bound` gives the largest of
    bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s and TF32
    operations over 495 TFLOP/s, as before the floor existed."""
    from rick_tpu_torch.tools.roofline import bound

    nbytes, f32_ops, tf32_ops = _roofline_case(key)
    t_bytes, t_ops = nbytes / 3.35e12, max(f32_ops / 67e12, tf32_ops / 495e12)
    want = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    assert bound(nbytes, f32_ops, tf32_ops) == pytest.approx(want) and bound(nbytes, f32_ops, tf32_ops)[1] == want[1]
    assert bound(nbytes, f32_ops, tf32_ops, launch_ms=0.0) == bound(nbytes, f32_ops, tf32_ops)
    # a floor below the larger term changes nothing
    assert bound(nbytes, f32_ops, tf32_ops, launch_ms=0.5 * want[0]) == bound(nbytes, f32_ops, tf32_ops)
    assert want[1] == ("operations" if key.startswith(("K4", "K6")) else "bytes")


@pytest.mark.parametrize("key", list(ROOFLINE_CASES))
def test_roofline_bound_returns_a_launch_floor_that_dominates(key):
    """A launch floor above the bytes' and operations' times is the bound,
    and what bounds the kernel is "launch"."""
    from rick_tpu_torch.tools.roofline import bound

    nbytes, f32_ops, tf32_ops = _roofline_case(key)
    floor = 2.0 * bound(nbytes, f32_ops, tf32_ops)[0]
    assert bound(nbytes, f32_ops, tf32_ops, launch_ms=floor) == (floor, "launch")
    # K3-bf16 at G's conv1: 0.1 MB, 3e-5 ms by bytes, below any launch
    if key.startswith("K3-bf16"):
        assert bound(nbytes, f32_ops, tf32_ops)[0] < 4e-5
        assert bound(nbytes, f32_ops, tf32_ops, launch_ms=8.6e-4) == (8.6e-4, "launch")


def test_wrappers_raise_on_other_devices():
    x = torch.empty((2, 4, 3, 3), device="meta")
    b = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_bias_act(x, b)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_bias_act_bwd(x, x, b)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.modconv_epilogue(x, torch.empty((2, 4), device="meta"), torch.empty((1, 1, 3, 3), device="meta"),
                             torch.empty((1,), device="meta"), b)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.convt_blur_act(x, torch.empty((4, 4, 3, 3), device="meta"), torch.empty((2, 4), device="meta"),
                           torch.empty((1, 1, 6, 6), device="meta"), b)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.modconv_act(x, torch.empty((2, 4), device="meta"), torch.empty((4, 4, 3, 3), device="meta"),
                        torch.empty((2, 4), device="meta"), torch.empty((1, 1, 3, 3), device="meta"),
                        torch.empty((1,), device="meta"), b)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.filtered_lrelu_act(torch.empty((2, 4, 13, 13), device="meta"), torch.empty((12,), device="meta"),
                               torch.empty((12,), device="meta"), b, up=2, down=2, padding=(9, 8, 9, 8))


def test_build_command_names_every_source_and_the_hopper_target():
    names = [p.name for p in _build.sources()]
    assert names == ["convt_blur_act.cu", "filtered_lrelu.cu", "fused_bias_act.cu", "launch_floor.cu",
                     "modconv_act.cu", "modconv_epilogue.cu"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    out = _build.build_path()
    assert out.parent == _build.BUILD_DIR and out.parent.name == "rick_tpu_torch"
    assert out == _build.build_path()  # the name depends on the sources only
    assert set(_build.SIGNATURES) == {
        "rick_fused_bias_act", "rick_fused_bias_act_bf16", "rick_fused_bias_act_bwd", "rick_modconv_epilogue",
        "rick_modconv_epilogue_bf16", "rick_convt_blur_act_stage", "rick_empty_launch",
        "rick_fused_bias_act_bf16_rows", "rick_modconv_epilogue_bf16_rows", "rick_modconv_act", "rick_filtered_lrelu",
    }


def test_every_entry_point_is_defined_in_csrc_with_its_signature():
    # the launch floor and the two redesigned bf16 entry points (each with
    # its trailing `int* launch`) among them
    assert {"rick_empty_launch", "rick_fused_bias_act_bf16", "rick_modconv_epilogue_bf16"} <= set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        srcs = [p.read_text() for p in _build.sources() if f'extern "C" int {name}(' in p.read_text()]
        assert len(srcs) == 1, name
        decl = srcs[0].split(f'extern "C" int {name}(')[1].split(")")[0]
        assert decl.count(",") + 1 == len(argtypes), name
        if name in ("rick_fused_bias_act_bf16", "rick_modconv_epilogue_bf16"):
            assert decl.split(",")[-1].split() == ["int*", "launch"], name
    assert _build.SIGNATURES["rick_empty_launch"] == [ctypes.c_int] * 3 + [ctypes.c_void_p]


def test_the_bf16_wrappers_launch_the_flat_kernels_only():
    """The two bf16 entry points launch the flat kernels; the row-per-block
    kernels they replaced are reachable only through their own `_rows`
    entry points, which no wrapper names."""
    src = {p.name: p.read_text() for p in _build.sources()}
    for file, entry, flat in (("fused_bias_act.cu", "rick_fused_bias_act_bf16", "launch_fba_bf16("),
                              ("modconv_epilogue.cu", "rick_modconv_epilogue_bf16", "launch_epi_bf16(")):
        body = src[file].split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
        assert flat in body and "launch_fba<" not in body and "launch_epi<" not in body, entry
    wrappers = (PACKAGE / "ops" / "kernels.py").read_text()
    assert "_rows" not in wrappers and "rick_fused_bias_act_bf16(" in wrappers and "rick_modconv_epilogue_bf16(" in wrappers


def test_import_leaves_jax_triton_and_cuda_alone():
    code = (
        "import sys, torch\n"
        "import rick_tpu_torch, rick_tpu_torch.ops, rick_tpu_torch.nn, rick_tpu_torch.ckpt\n"
        "import rick_tpu_torch.train, rick_tpu_torch.utils, rick_tpu_torch.metrics\n"
        "import rick_tpu_torch.data, rick_tpu_torch.cli, rick_tpu_torch.cli.train, rick_tpu_torch.ckpt.async_io\n"
        "import rick_tpu_torch.cli.fid, rick_tpu_torch.cli.kid, rick_tpu_torch.cli.precision_recall\n"
        "import rick_tpu_torch.cli.intra_lpips, rick_tpu_torch.cli.prepare_data, rick_tpu_torch.cli.convert_lmdb\n"
        "import rick_tpu_torch.dist, rick_tpu_torch.data.prepare, rick_tpu_torch.tools.dryrun_multigpu\n"
        "import rick_tpu_torch.data.jpeg, rick_tpu_torch.data.image\n"
        "bad = [m for m in ('jax', 'triton', 'PIL', 'cv2') if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m.startswith('rick_tpu.') or m == 'rick_tpu']\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "from rick_tpu_torch.ops import _build\n"
        "assert _build._lib is None\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PACKAGE.parent, timeout=120)


# the environment variables the package may read: each picks a metric's
# weights or arithmetic, or ADA's warp lowering and its tile, as in rick_tpu,
# and none of them a kernel; those the train CLI reads as rick_tpu's does (the
# cache eviction, the best.pt throttle); and torchrun's, which place a rank in
# its launch (`dist.initialize_multihost`; MASTER_ADDR and MASTER_PORT are
# read by torch's own env:// rendezvous)
METRIC_ENV = {"RICK_INCEPTION_WEIGHTS", "RICK_VGG16_WEIGHTS", "RICK_LPIPS_WEIGHTS", "RICK_FID_HOST_SQRTM",
              "RICK_ADA_WARP", "RICK_ADA_WARP_TILE"}
CLI_ENV = {"RICK_CLEAR_REAL_CACHE", "RICK_BEST_SAVE_INTERVAL_S", "WORLD_SIZE", "RANK", "LOCAL_RANK",
           "LOCAL_WORLD_SIZE"}


def _zlib_error_to_value_error(node: ast.Try) -> bool:
    """`try: ... except zlib.error: raise ValueError(...)`, and nothing else:
    corrupt Deflate data becomes the decoder's ValueError naming the file.
    It falls back to nothing."""
    (h,) = node.handlers if len(node.handlers) == 1 else (None,)
    return (h is not None and not node.orelse and not node.finalbody and ast.unparse(h.type) == "zlib.error"
            and len(h.body) == 1 and isinstance(h.body[0], ast.Raise) and isinstance(h.body[0].exc, ast.Call)
            and ast.unparse(h.body[0].exc.func) == "ValueError")


def test_package_has_no_env_gates_and_no_jax():
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        allowed = set()  # os.environ nodes inside os.environ.get(<a METRIC_ENV name>, ...)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "get"
                    and isinstance(node.func.value, ast.Attribute) and node.func.value.attr == "environ"
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value in METRIC_ENV | CLI_ENV):
                allowed.add(id(node.func.value))
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(m == "jax" or m.startswith(("jax.", "rick_tpu.")) or m == "rick_tpu" for m in names), path
                assert "environ" not in names and "getenv" not in names, f"{path}:{node.lineno}"
            if isinstance(node, ast.Attribute) and id(node) not in allowed:
                assert node.attr not in ("environ", "getenv"), f"{path}:{node.lineno}"
            assert not isinstance(node, ast.Try) or _zlib_error_to_value_error(node), \
                f"{path}:{node.lineno}: no try/fallback in the port"
