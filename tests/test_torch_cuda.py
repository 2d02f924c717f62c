"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, carries the `cuda` marker and
skips without a card.  The file imports neither jax nor the tests' conftest
helpers, because the machine with the card has no jax:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

TF32 is off; each tolerance is relative to max|ref| and stated where used.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rick_tpu_torch import ops
from rick_tpu_torch.nn import Discriminator, Generator, Generator3, Generator3Config
from rick_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0, device="cpu"):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _rel(got, ref) -> float:
    return float((got.double().cpu() - ref.double().cpu()).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (4, 32), (3, 5, 7, 9), (2, 3, 1, 1)])
def test_fused_bias_act_kernel_matches_plain(cuda, shape):
    x = _rand(shape, 0, device=cuda)
    b = _rand((shape[-1] if len(shape) == 2 else shape[1],), 1, device=cuda)
    before = ops.fused_bias_act.launches
    got = ops.fused_bias_act(x, b)
    assert ops.fused_bias_act.launches == before + 1
    assert _rel(got, ops.fused_bias_act_ref(x, b)) <= 1e-6  # elementwise, same order


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (3, 5, 7, 9)])
@pytest.mark.parametrize("noise_batch", ["B", "1"])
def test_modconv_epilogue_kernel_matches_plain(cuda, shape, noise_batch):
    B, C, H, W = shape
    a = (_rand(shape, 0, device=cuda), _rand((B, C), 1, device=cuda).abs() + 0.1,
         _rand((B if noise_batch == "B" else 1, 1, H, W), 2, device=cuda),
         torch.tensor([0.7], device=cuda), _rand((C,), 3, device=cuda))
    assert _rel(ops.modconv_epilogue(*a), ops.modconv_epilogue_ref(*a)) <= 1e-6  # one FMA contraction


def _convt_args(N, Cin, Cout, H, noise_batch, device):
    return [
        _rand((N, Cin, H, H), 0, device=device),
        _rand((Cout, Cin, 3, 3), 1, 1.0 / (9 * Cin) ** 0.5, device=device),
        _rand((N, Cout), 2, device=device).abs() + 0.5,
        _rand((noise_batch or N, 1, 2 * H, 2 * H), 3, 0.1, device=device),
        _rand((Cout,), 4, 0.1, device=device),
    ]


# The kernel's tiles: output edge 8 (H <= 4), 16 (H <= 8), 32 (from H = 9 on,
# ragged at H = 17 and 33); Cin 40 leaves a partial 32-channel chunk, Cout 48
# and 4 a partial 32-channel block; H = 4, 8, 16 at 512 -> 512 are the
# generator's small upsample layers, one per tile
CONVT_CARD_CASES = [(2, 8, 8, 8), (1, 16, 8, 4), (3, 8, 16, 16), (1, 8, 256, 8), (2, 40, 48, 5), (1, 512, 64, 4),
                    (2, 32, 32, 33), (2, 16, 32, 17), (2, 40, 48, 33), (1, 24, 4, 9), (1, 40, 4, 17),
                    (1, 512, 512, 4), (1, 512, 512, 8), (1, 512, 512, 16)]


@pytest.mark.parametrize("N,Cin,Cout,H", CONVT_CARD_CASES)
@pytest.mark.parametrize("noise_batch", [None, 1], ids=["noise_B", "noise_1"])
def test_convt_blur_act_kernel_matches_plain(cuda, N, Cin, Cout, H, noise_batch):
    a = _convt_args(N, Cin, Cout, H, noise_batch, cuda)
    # sums of 9*Cin products (3xTF32, f32 accumulation) in another order than cuDNN: 1e-4
    assert _rel(ops.convt_blur_act(*a), ops.convt_blur_act_ref(*a)) <= 1e-4
    a[4] = None
    assert _rel(ops.convt_blur_act(*a, use_act=False), ops.convt_blur_act_ref(*a, use_act=False)) <= 1e-4


def _modconv_act_args(N, Cin, Cout, H, noise_batch, device, W=None):
    W = H if W is None else W
    return [
        _rand((N, Cin, H, W), 0, device=device),
        _rand((N, Cin), 1, 0.3, device=device) + 1.0,
        _rand((Cout, Cin, 3, 3), 2, 1.0 / (9 * Cin) ** 0.5, device=device),
        _rand((N, Cout), 3, device=device).abs() + 0.5,
        _rand((noise_batch or N, 1, H, W), 4, device=device),
        torch.tensor([0.3], device=device),
        _rand((Cout,), 5, 0.1, device=device),
    ]


# G's seven stride-1 StyledConvs at 256px and batch 100 (the evaluation's
# chunk), then a ragged batch of 3 on each small tile (4x4: 8 images a tile,
# 8x8: 2), odd shapes (W % 4 padded, ragged tiles, Cin not a multiple of 8,
# Cout not a multiple of 128)
MODCONV_ACT_CARD_CASES = [(100, 512, 512, 4), (100, 512, 512, 8), (100, 512, 512, 16), (100, 512, 512, 32),
                          (100, 512, 512, 64), (100, 256, 256, 128), (100, 128, 128, 256),
                          (3, 512, 512, 4), (3, 512, 512, 8), (3, 40, 136, 17), (2, 12, 20, 5), (2, 16, 8, 33)]


@pytest.mark.parametrize("N,Cin,Cout,H", MODCONV_ACT_CARD_CASES)
@pytest.mark.parametrize("noise_batch", [None, 1], ids=["noise_B", "noise_1"])
def test_modconv_act_kernel_matches_plain(cuda, N, Cin, Cout, H, noise_batch):
    a = _modconv_act_args(N, Cin, Cout, H, noise_batch, cuda)
    before = ops.modconv_act.launches
    with torch.inference_mode():
        got = ops.modconv_act(*a)
        ref = ops.modconv_act_ref(*a)
    assert ops.modconv_act.launches == before + 1
    # sums of 9*Cin products (3xTF32, f32 accumulation) in another order than cuDNN: 1e-4
    assert _rel(got, ref) <= 1e-4


# StyleGAN3-T's 3x3 convs at 256px as `nn/stylegan3.py` routes them into K6: the
# input padded by 1, so that K6's padding 1 is the layer's padding 2 (conv sides
# 38 to 278, odd multiples of 2 on which the wrapper pads rows to 4 floats), Cin
# 362, 181 and 91 (not multiples of 8), a zero noise of weight 0, slope 1, gain 1
SG3_MODCONV_CASES = [(4, 512, 512, 38), (4, 512, 512, 54), (4, 512, 512, 86), (4, 512, 362, 86),
                     (4, 362, 256, 150), (4, 256, 181, 150), (4, 181, 128, 150), (2, 128, 91, 278), (2, 91, 64, 278),
                     (2, 64, 64, 278)]


@pytest.mark.parametrize("N,Cin,Cout,side", SG3_MODCONV_CASES)
def test_modconv_act_kernel_at_stylegan3_shapes(cuda, N, Cin, Cout, side):
    x = F.pad(_rand((N, Cin, side - 2, side - 2), 0, device=cuda), (1, 1, 1, 1))
    noise = torch.zeros((1, 1, side, side), device=cuda)
    a = [x, _rand((N, Cin), 1, 0.3, device=cuda) + 1.0, _rand((Cout, Cin, 3, 3), 2, device=cuda),
         _rand((N, Cout), 3, device=cuda).abs() * 0.01 + 0.005, noise, torch.zeros(1, device=cuda),
         _rand((Cout,), 5, 0.1, device=cuda)]
    before = ops.modconv_act.launches
    with torch.inference_mode():
        got = ops.modconv_act(*a, slope=1.0, gain=1.0)
        ref = ops.modconv_act_ref(*a, slope=1.0, gain=1.0)
    assert ops.modconv_act.launches == before + 1 and got.shape == (N, Cout, side, side)
    # sums of 9*Cin products (3xTF32, f32 accumulation) in another order than cuDNN: 1e-4
    assert _rel(got, ref) <= 1e-4


# StyleGAN3-T's filtered leaky ReLUs at 256px (`Generator3Config().layers()`):
# (input side, up, padding), with 6 up taps up and 12 down; then the kernel's
# other instances, each phase (-py0) mod up of its fused y pass (the layers
# take 1 at up 2 and 2 at up 4), one with an odd side and a padding whose x
# and y differ
SG3_FLRELU_CASES = [(38, 2, (9, 8, 9, 8)), (38, 4, (-6, -9, -6, -9)), (54, 2, (9, 8, 9, 8)),
                    (54, 4, (-6, -9, -6, -9)), (86, 2, (9, 8, 9, 8)), (86, 4, (-6, -9, -6, -9)),
                    (150, 2, (9, 8, 9, 8)), (150, 4, (-6, -9, -6, -9)), (278, 2, (9, 8, 9, 8)),
                    (278, 2, (-11, -12, -11, -12)), (54, 2, (8, 9, 8, 9)), (38, 4, (4, 1, 4, 1)),
                    (40, 4, (-5, 2, -5, 2)), (61, 4, (3, -2, -7, 5))]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("side,up,padding", SG3_FLRELU_CASES)
def test_filtered_lrelu_act_kernel_matches_the_chain(cuda, side, up, padding, bias):
    """K7 against the plain chain on non-symmetric random filters (which
    pin each filter's orientation), with the clamp reached: 1e-5 of
    max|chain| (f32 sums of 6 to 12 products per pass in another order)."""
    x = _rand((2, 3, side, side), 0, 60.0, device=cuda)
    fu, fd = _rand((6 * up,), 1, 0.3, device=cuda), _rand((12,), 2, 0.3, device=cuda)
    b = _rand((3,), 3, device=cuda) if bias else None
    kw = dict(up=up, down=2, padding=padding, gain=2**0.5, slope=0.2, clamp=256.0)
    before = ops.filtered_lrelu_act.launches
    with torch.inference_mode():
        got = ops.filtered_lrelu_act(x, fu, fd, b, **kw)
        ref = ops.filtered_lrelu_ref(x, fu, fd, b, **kw)
    assert ops.filtered_lrelu_act.launches == before + 1 and got.shape == ref.shape
    assert bool((ref.abs() >= 256).any() or (ref.abs() > 100).any())
    assert _rel(got, ref) <= 1e-5


def test_filtered_lrelu_act_raises_on_the_card(cuda):
    x, fu, fd = _rand((1, 2, 38, 38), 0, device=cuda), _rand((12,), 1, device=cuda), _rand((12,), 2, device=cuda)
    kw = dict(up=2, down=2, padding=(9, 8, 9, 8))
    with pytest.raises(NotImplementedError):
        ops.filtered_lrelu_act(x.clone().requires_grad_(True), fu, fd, None, **kw)
    with pytest.raises(ValueError, match="dtype"):
        ops.filtered_lrelu_act(x.double(), fu, fd, None, **kw)
    with pytest.raises(ValueError, match="is on"):
        ops.filtered_lrelu_act(x, fu.cpu(), fd, None, **kw)
    with pytest.raises(ValueError, match="the kernel takes up"):
        ops.filtered_lrelu_act(x, fu, fd, None, **dict(kw, up=1))


def test_generator3_fast_path_matches_the_plain_path_on_the_card(cuda):
    """StyleGAN3-T at 256px, batch 4: fast=True (K6 for the 14 3x3 convs and
    K7 for the 14 filtered leaky ReLUs, 14 launches each; ToRGB's on the
    plain chain) against fast=False (cuDNN f32 and the plain chain); 1e-4 of
    max|plain| (K6's 1e-4 per conv does not grow through the layers: each is
    normalized by demodulation; K7 adds f32 rounding)."""
    g = Generator3(Generator3Config(), rng=torch.Generator(device=cuda).manual_seed(0), device=cuda).eval()
    with torch.no_grad():
        g.synthesis.input.affine.weight.normal_(0.0, 0.1, generator=torch.Generator(device=cuda).manual_seed(1))
        for p in g.synthesis.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda) * 0.1)
    z = torch.randn((4, 512), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    before, before_k7 = ops.modconv_act.launches, ops.filtered_lrelu_act.launches
    with torch.inference_mode():
        with trace.recording():
            fast, _ = g([z], fast=True)
            calls = {k: c for k, (c, _) in trace.counters().items()}
        plain, _ = g([z])
    assert ops.modconv_act.launches == before + 14 and ops.filtered_lrelu_act.launches == before_k7 + 14
    assert calls["ops.modconv_act"] == 14 and calls["ops.filtered_lrelu_act"] == 14
    assert calls["ops.filtered_lrelu"] == 1
    assert fast.shape == (4, 3, 256, 256) and float(plain.std()) > 0.01
    assert _rel(fast, plain) <= 1e-4


def test_modconv_act_raises_under_autograd_on_bf16_and_on_bad_shapes(cuda):
    a = _modconv_act_args(2, 8, 8, 4, None, cuda)
    a[1].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        ops.modconv_act(*a)
    with torch.no_grad():
        ops.modconv_act(*a)
    a[1] = a[1].detach()
    with pytest.raises(ValueError, match="dtype"):
        ops.modconv_act(a[0].bfloat16(), *a[1:])
    with pytest.raises(ValueError, match="dtype"):
        ops.modconv_act(*a[:3], a[3].bfloat16(), *a[4:])
    with pytest.raises(ValueError, match="weight"):
        ops.modconv_act(a[0], a[1], a[2][:, :, :2, :2].contiguous(), *a[3:])
    with pytest.raises(ValueError, match="s "):
        ops.modconv_act(a[0], a[1][:, :4].contiguous(), *a[2:])
    with pytest.raises(ValueError, match="demod"):
        ops.modconv_act(*a[:3], a[3][:1].contiguous(), *a[4:])
    with pytest.raises(ValueError, match="noise"):
        ops.modconv_act(*a[:4], torch.zeros((2, 1, 8, 8), device=cuda), *a[5:])
    with pytest.raises(ValueError, match="bias"):
        ops.modconv_act(*a[:6], torch.zeros(5, device=cuda))
    with pytest.raises(ValueError, match="4-D"):
        ops.modconv_act(a[0][0], *a[1:])


def test_wrappers_count_their_calls_on_the_card(cuda):
    """Inside `trace.recording()` each wrapper call on the card is counted
    once with its host time, a backward's K2 among them; outside, none."""
    from rick_tpu_torch.utils import trace

    x = _rand((2, 8, 16, 16), 0, device=cuda).requires_grad_(True)
    b = _rand((8,), 1, device=cuda)
    with trace.recording():
        ops.fused_bias_act(x, b).sum().backward()
        got = trace.counters()
    assert {k: calls for k, (calls, _) in got.items()} == {"ops.fused_bias_act": 1, "ops.fused_bias_act_bwd": 1}
    assert all(ns > 0 for _, ns in got.values())
    ops.fused_bias_act(x.detach(), b)
    assert trace.counters() == got


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (4, 32), (3, 5, 7, 9), (2, 3, 1, 1)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_bias_act_bwd_kernel_matches_plain(cuda, shape, with_bias):
    g, y = _rand(shape, 0, device=cuda), _rand(shape, 1, device=cuda)
    b = _rand((shape[-1] if len(shape) == 2 else shape[1],), 2, device=cuda) if with_bias else None
    before = ops.fused_bias_act_bwd.launches
    got = ops.fused_bias_act_bwd(g, y, b)
    assert ops.fused_bias_act_bwd.launches == before + 1
    assert _rel(got, ops.fused_bias_act_bwd_ref(g, y, b)) <= 1e-6  # elementwise, same order


def _grads_and_double_grads(f, args, seed):
    """First grads of <f(args), w> and the grads of <first grads, u> with
    respect to w and args."""
    y = f(*args)
    w = _rand(tuple(y.shape), seed, device=y.device).requires_grad_(True)
    first = torch.autograd.grad(y, args, w, create_graph=True)
    us = [_rand(tuple(g.shape), seed + 1 + i, device=y.device) for i, g in enumerate(first)]
    second = torch.autograd.grad(sum((g * u).sum() for g, u in zip(first, us)), (w,) + tuple(args), allow_unused=True)
    return [g.detach() for g in first] + [torch.zeros(()) if g is None else g.detach() for g in second]


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (4, 32)])
def test_fused_bias_act_grads_and_double_grads_match_plain_autograd(cuda, shape):
    x = _rand(shape, 0, device=cuda).requires_grad_(True)
    b = _rand((shape[-1] if len(shape) == 2 else shape[1],), 1, device=cuda).requires_grad_(True)
    before = ops.fused_bias_act_bwd.launches
    got = _grads_and_double_grads(ops.fused_bias_act, (x, b), 5)
    assert ops.fused_bias_act_bwd.launches == before + 2  # the backward and the double backward
    want = _grads_and_double_grads(ops.fused_bias_act_ref, (x, b), 5)
    for a, r in zip(got, want):
        assert _rel(a, r) <= 1e-6 if r.abs().max() > 0 else not a.any()


@pytest.mark.parametrize("noise_batch", [2, 1])
def test_modconv_epilogue_grads_and_double_grads_match_plain_autograd(cuda, noise_batch):
    args = [_rand((2, 8, 16, 16), 0, device=cuda), _rand((2, 8), 1, device=cuda).abs() + 0.1,
            _rand((noise_batch, 1, 16, 16), 2, device=cuda), torch.tensor([0.7], device=cuda),
            _rand((8,), 3, device=cuda)]
    args = [a.requires_grad_(True) for a in args]
    got = _grads_and_double_grads(ops.modconv_epilogue, args, 7)
    want = _grads_and_double_grads(ops.modconv_epilogue_ref, args, 7)
    # sums over space and batch in the same order on both sides: 1e-5
    for a, r in zip(got, want):
        assert _rel(a, r) <= 1e-5 if r.abs().max() > 0 else not a.any()


def test_kernels_raise_under_autograd_and_on_bad_input(cuda):
    """Only K4, which is forward only as in JAX, raises under autograd."""
    x = torch.randn((2, 4, 3, 3), device=cuda, requires_grad=True)
    b = torch.zeros(4, device=cuda)
    ops.fused_bias_act(x, b).sum().backward()  # differentiable
    convt = [torch.randn((1, 4, 3, 3), device=cuda, requires_grad=True), torch.randn((4, 4, 3, 3), device=cuda),
             torch.ones((1, 4), device=cuda), torch.zeros((1, 1, 6, 6), device=cuda), b]
    with pytest.raises(NotImplementedError):
        ops.convt_blur_act(*convt)
    with torch.no_grad():
        ops.convt_blur_act(*convt)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_bias_act(torch.randn((4, 2, 3, 3), device=cuda).transpose(0, 1), b)
    with pytest.raises(ValueError, match="dtype"):
        ops.fused_bias_act(x.detach().double(), b)
    with pytest.raises(ValueError, match="bias"):
        ops.fused_bias_act(x.detach(), torch.zeros(5, device=cuda))
    with pytest.raises(ValueError, match="bias"):
        ops.fused_bias_act_bwd(x.detach(), x.detach(), torch.zeros(5, device=cuda))


@pytest.mark.parametrize("shape", [(2, 128, 64, 64), (4, 32), (3, 5, 7, 9)])
def test_fused_bias_act_bf16_kernel_and_grads_match_plain(cuda, shape):
    """K1's bf16 instantiation (bf16 x, f32 bias, f32 y) against its plain
    version: y exactly the same arithmetic (1e-6); through autograd gx bf16
    (K2's f32 result rounded once) and gb f32.  K2 applies the slope before
    the gain, plain autograd after it: an f32 ulp that the rounding may
    carry to one bf16 step (2^-8) of gx; gb, an f32 sum in another order,
    1e-5."""
    c = shape[-1] if len(shape) == 2 else shape[1]
    x = _rand(shape, 0, device=cuda).bfloat16().requires_grad_(True)
    b = _rand((c,), 1, 0.3, device=cuda).requires_grad_(True)
    w = _rand(shape, 2, device=cuda)
    before, before_f32 = ops.fused_bias_act.launches_bf16, ops.fused_bias_act.launches
    y = ops.fused_bias_act(x, b)
    assert (ops.fused_bias_act.launches_bf16, ops.fused_bias_act.launches) == (before + 1, before_f32)
    ref = ops.fused_bias_act_ref(x, b)
    assert y.dtype == ref.dtype == torch.float32 and _rel(y, ref) <= 1e-6
    got = torch.autograd.grad(y, (x, b), w)
    want = torch.autograd.grad(ref, (x, b), w)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32]
    assert _rel(got[0].float(), want[0].float()) <= 2.0**-8 and _rel(got[1], want[1]) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 512, 4, 4), (2, 6, 5, 5)])
@pytest.mark.parametrize("noise_batch", ["B", "1"])
def test_modconv_epilogue_bf16_kernel_and_grads_match_plain(cuda, shape, noise_batch):
    """K3's bf16 instantiation (bf16 out, demod, noise and noise weight, f32
    bias, f32 y) against its plain version: the same roundings, 1e-6 of
    max|ref|; through autograd the bf16 operands' grads bf16 and the bias's
    f32.  d_out one bf16 step (2^-8) of max|ref| (K2 and plain autograd
    apply slope and gain in another order), the bf16 sums over a layer
    (demod, noise) four steps, the noise weight's, one sum that cancels to a
    small part of its terms, 5e-2 (chip_smoke.py's rule for one-element
    params), the bias's 1e-5."""
    B, C, H, W = shape
    a = [_rand(shape, 0, device=cuda).bfloat16(), (_rand((B, C), 1, device=cuda).abs() + 0.1).bfloat16(),
         _rand((B if noise_batch == "B" else 1, 1, H, W), 2, device=cuda).bfloat16(),
         torch.tensor([0.7], device=cuda).bfloat16(), _rand((C,), 3, 0.3, device=cuda)]
    a = [t.requires_grad_(True) for t in a]
    w = _rand(shape, 4, device=cuda)
    before, before_f32 = ops.modconv_epilogue.launches_bf16, ops.modconv_epilogue.launches
    y = ops.modconv_epilogue(*a)
    assert (ops.modconv_epilogue.launches_bf16, ops.modconv_epilogue.launches) == (before + 1, before_f32)
    ref = ops.modconv_epilogue_ref(*a)
    assert y.dtype == ref.dtype == torch.float32 and _rel(y, ref) <= 1e-6
    got, want = torch.autograd.grad(y, a, w), torch.autograd.grad(ref, a, w)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32]
    for g_, r, tol in zip(got, want, [2.0**-8, 4 * 2.0**-8, 4 * 2.0**-8, 5e-2, 1e-5]):
        assert _rel(g_.float(), r.float()) <= tol


def _bf16_misaligned(shape, seed, device):
    """A contiguous bf16 tensor 2 bytes past a 16-byte boundary: a slice of a
    larger buffer."""
    n = int(np.prod(shape))
    t = _rand((n + 1,), seed, device=device).bfloat16()[1:].view(shape)
    assert t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("shape,misaligned", [((2, 3, 6, 6), False), ((3, 5, 7, 9), False), ((2, 8, 16, 16), True),
                                              ((4, 32), False), ((2, 128, 256, 256), False)],
                         ids=["inner_mod8_4", "odd_inner", "x_2_bytes_past_16", "2d", "d_from_rgb"])
def test_fused_bias_act_bf16_flat_kernel_paths_match_plain(cuda, shape, misaligned):
    """K1-bf16 on each of its load paths (16-byte, 8-byte where inner % 8 ==
    4, single elements for an odd inner, a misaligned x and the 2-D layout):
    the same arithmetic as its plain version, 1e-6 of max|ref|, one launch
    counted in launches_bf16."""
    c = shape[-1] if len(shape) == 2 else shape[1]
    x = _bf16_misaligned(shape, 0, cuda) if misaligned else _rand(shape, 0, device=cuda).bfloat16()
    b = _rand((c,), 1, 0.3, device=cuda)
    before = ops.fused_bias_act.launches_bf16
    y = ops.fused_bias_act(x, b)
    assert ops.fused_bias_act.launches_bf16 == before + 1
    assert _rel(y, ops.fused_bias_act_ref(x, b)) <= 1e-6


@pytest.mark.parametrize("shape,noise_batch,misaligned", [
    ((2, 512, 4, 4), 2, False), ((2, 512, 4, 4), 1, False), ((2, 6, 6, 6), 2, False), ((2, 3, 5, 7), 2, False),
    ((2, 3, 5, 7), 1, False), ((2, 512, 4, 4), 2, True), ((4, 128, 64, 64), 4, False)],
    ids=["conv1_noise_B", "conv1_noise_1", "hw_mod8_4", "odd_hw_noise_B", "odd_hw_noise_1", "out_2_bytes_past_16",
         "streaming"])
def test_modconv_epilogue_bf16_flat_kernel_paths_match_plain(cuda, shape, noise_batch, misaligned):
    """K3-bf16 on each of its load paths (16-byte, 8-byte where hw % 8 == 4,
    single elements for an odd hw or a misaligned out), noise batch B and 1:
    the same roundings as its plain version, 1e-6 of max|ref|, one launch
    counted in launches_bf16."""
    B, C, H, W = shape
    out = _bf16_misaligned(shape, 0, cuda) if misaligned else _rand(shape, 0, device=cuda).bfloat16()
    a = (out, (_rand((B, C), 1, device=cuda).abs() + 0.1).bfloat16(),
         _rand((noise_batch, 1, H, W), 2, device=cuda).bfloat16(), torch.tensor([0.7], device=cuda).bfloat16(),
         _rand((C,), 3, 0.3, device=cuda))
    before = ops.modconv_epilogue.launches_bf16
    y = ops.modconv_epilogue(*a)
    assert ops.modconv_epilogue.launches_bf16 == before + 1
    assert _rel(y, ops.modconv_epilogue_ref(*a)) <= 1e-6


def test_kernels_refuse_other_dtypes(cuda):
    """fp16, or a bias that is not f32, raises: neither instantiation takes it."""
    x = torch.randn((2, 4, 3, 3), device=cuda)
    b = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.fused_bias_act(x.half(), b)
    with pytest.raises(ValueError, match="bias"):
        ops.fused_bias_act(x.bfloat16(), b.bfloat16())
    epi = [x.bfloat16(), torch.ones((2, 4), device=cuda).bfloat16(), torch.zeros((1, 1, 3, 3), device=cuda).bfloat16(),
           torch.ones(1, device=cuda).bfloat16(), b]
    with pytest.raises(ValueError, match="dtype"):
        ops.modconv_epilogue(*[t.half() if t.dtype == torch.bfloat16 else t for t in epi])
    with pytest.raises(ValueError, match="demod"):
        ops.modconv_epilogue(epi[0], epi[1].float(), *epi[2:])
    with pytest.raises(ValueError, match="bias"):
        ops.modconv_epilogue(*epi[:4], b.bfloat16())


def test_small_generator_and_discriminator_match_the_cpu_path(cuda):
    """G (fixed and mixing) and D at 32px, on the card through the kernels
    and on the CPU through the plain versions: 1e-4 of max|ref|."""
    g = Generator(32, rng=torch.Generator().manual_seed(0))
    d = Discriminator(32, rng=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    z1, z2 = _rand((3, 512), 5), _rand((3, 512), 6)
    with torch.inference_mode():
        want, want_f = g([z1, z2], inject_index=3, return_feats=True)
        want_s = d(want)[0]
        ops.reset_launch_counts()
        g_c, d_c = g.to(cuda), d.to(cuda)
        got, got_f = g_c([z1.to(cuda), z2.to(cuda)], inject_index=3, return_feats=True, fast=True)
        got_s = d_c(want.to(cuda))[0]
    counts = ops.launch_counts()
    # G's stride-1 StyledConvs take K6 under fast=True, so K3 (f32) stays 0 here
    assert counts.pop("fused_bias_act_bwd") == 0 and counts.pop("modconv_epilogue") == 0, counts
    assert all(v > 0 for v in counts.values()), counts
    for a, b in [(got, want), (got_s, want_s)] + list(zip(got_f, want_f)):
        assert _rel(a, b) <= 1e-4


def test_small_training_iteration_matches_the_cpu_path(cuda):
    """One 16px iteration with every phase (R1 and path length included) on
    the card and on the CPU, from the same state and draws.  The state is two
    CPU iterations in, with Adam's second moments lifted to 1e-2 of each
    tensor's largest, so that no gradient's rounding noise becomes a whole
    step.  Losses within 1e-3 (the path penalty squares a gradient taken
    through all of G).  The step each param took, per tensor in norm, as
    chip_smoke.py compares each tensor: |step_card - step_cpu| <= 1% of
    |step_cpu| (5% for a one-element noise weight, whose gradient is one sum
    over a layer that cancels to a small part of its terms; here each alone,
    at 256px chip_smoke.py holds them as one vector) + an RMS of 0.1% of lr
    per entry.  The two sum every conv in another order, and two card runs
    of the same iteration differ from each other as much: through the path
    penalty's double backward, single entries of a step move by up to ~0.6%
    of its largest entry."""
    import copy

    from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
    from rick_tpu_torch.train import TrainConfig, init_train_state, run_iteration, sample_draws

    gcfg, dcfg = GeneratorConfig(size=16), DiscriminatorConfig(size=16)
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=0)
    cpu = init_train_state(gcfg, dcfg, tcfg, rng=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    for i in (1, 2):
        run_iteration(cpu, tcfg, torch.randn((2, 3, 16, 16), generator=gen), i, gen=gen)
    for opt in (cpu.g_opt, cpu.d_opt):
        for st in opt.state.values():
            st["exp_avg_sq"] += 1e-2 * st["exp_avg_sq"].max()
    draws = {"d": sample_draws(gen, gcfg, tcfg, 2), "g": sample_draws(gen, gcfg, tcfg, 2),
             "path": sample_draws(gen, gcfg, tcfg, 1, path=True)}
    real = torch.randn((2, 3, 16, 16), generator=gen)
    cpu_before = copy.deepcopy(cpu)
    card = copy.deepcopy(cpu).to(cuda)
    ops.reset_launch_counts()
    got = run_iteration(card, tcfg, real.to(cuda), 0, draws={k: v.to(cuda) for k, v in draws.items()})
    assert all(v > 0 for k, v in ops.launch_counts().items() if k not in ("convt_blur_act", "modconv_act"))
    assert ops.modconv_act.launches == 0  # generation only, like convt_blur_act
    want = run_iteration(cpu, tcfg, real, 0, draws=draws)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-3 * max(1.0, abs(float(want[k]))), k
    for name in ("g", "d", "g_ema", "d_ema"):
        lr = tcfg.d_lr if name[0] == "d" else tcfg.g_lr
        lr = lr * (1.0 - tcfg.ema_accum) if name.endswith("_ema") else lr
        a, b = getattr(card, name).state_dict(), getattr(cpu, name).state_dict()
        start = getattr(cpu_before, name).state_dict()
        for k in b:
            step_card = a[k].cpu().double() - start[k].double()
            step_cpu = b[k].double() - start[k].double()
            err = float((step_card - step_cpu).norm())
            rtol = 5e-2 if step_cpu.numel() == 1 else 1e-2
            assert err <= rtol * float(step_cpu.norm()) + 1e-3 * lr * step_cpu.numel() ** 0.5, (name, k, err)


def test_ada_augment_and_d_phase_match_the_cpu_path(cuda):
    """ADA at 32px, margin 24: the augment of 4 images at p = 1 (matrices
    made on the CPU) and the gradient of sum(out * w) with respect to the
    image, card against CPU within 1e-5 of max|ref| (the same gather and
    coordinates; cuDNN sums the FIR in another order, the scatter-add's
    atomics add in any order).  Then a D phase with augment and the p update
    firing from the same state and draws: the loss within 1e-3, p, its pool
    and r_t within 1e-6, and D's step per tensor in norm as in the training
    test above."""
    import copy

    from rick_tpu_torch.augment import augment, sample_affine, sample_color
    from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
    from rick_tpu_torch.train import TrainConfig, init_train_state, sample_draws
    from rick_tpu_torch.train import steps

    gen = torch.Generator().manual_seed(3)
    img, w = torch.randn((4, 3, 32, 32), generator=gen), torch.randn((4, 3, 32, 32), generator=gen)
    one = torch.ones(())
    G, C = sample_affine(gen, one, 4, 32, 32), sample_color(gen, one, 4)
    outs = []
    for dev in ("cpu", cuda):
        x = img.to(dev).requires_grad_(True)
        out, _ = augment(x, one.to(dev), margin=24, transform=(G.to(dev), C.to(dev)))
        outs.append((out, torch.autograd.grad((out * w.to(dev)).sum(), x)[0]))
    for ref, got in zip(*outs):
        assert _rel(got, ref) <= 1e-5

    gcfg, dcfg = GeneratorConfig(size=32), DiscriminatorConfig(size=32)
    tcfg = TrainConfig(batch=2, augment=True, warmup_iter=0, ada_margin=24)
    cpu = init_train_state(gcfg, dcfg, tcfg, rng=torch.Generator().manual_seed(0), device="cpu")
    # one D phase in (p = 0), then Adam's second moments lifted as above
    steps.d_phase(cpu, tcfg, torch.randn((2, 3, 32, 32), generator=gen),
                  sample_draws(gen, gcfg, tcfg, 2, ada_p=cpu.ada_p, ada_batch=4), False)
    for st in cpu.d_opt.state.values():
        st["exp_avg_sq"] += 1e-2 * st["exp_avg_sq"].max()
    cpu.ada_p, cpu.ada_stats = torch.tensor(0.5), torch.tensor([0.0, 254.0])
    draws = sample_draws(gen, gcfg, tcfg, 2, ada_p=cpu.ada_p, ada_batch=4)
    real = torch.randn((2, 3, 32, 32), generator=gen)
    start = copy.deepcopy(cpu.d.state_dict())
    card = copy.deepcopy(cpu).to(cuda)
    got, _ = steps.d_phase(card, tcfg, real.to(cuda), draws.to(cuda), False)
    want, _ = steps.d_phase(cpu, tcfg, real, draws, False)
    assert abs(float(got["d"]) - float(want["d"])) <= 1e-3 * max(1.0, abs(float(want["d"])))
    assert float(cpu.ada_p) != 0.5
    for k in ("ada_p", "ada_stats", "r_t"):
        assert float((getattr(card, k).cpu() - getattr(cpu, k)).abs().max()) <= 1e-6, k
    a, b = card.d.state_dict(), cpu.d.state_dict()
    for k in b:
        step_card, step_cpu = a[k].cpu().double() - start[k].double(), b[k].double() - start[k].double()
        err = float((step_card - step_cpu).norm())
        rtol = 5e-2 if step_cpu.numel() == 1 else 1e-2
        assert err <= rtol * float(step_cpu.norm()) + 1e-3 * tcfg.d_lr * step_cpu.numel() ** 0.5, k


@pytest.mark.parametrize("N,Cin,Cout,H", [(2, 8, 8, 4), (1, 16, 4, 8), (2, 32, 32, 33), (1, 512, 64, 4),
                                          (2, 40, 48, 17), (1, 24, 4, 9), (1, 512, 512, 8), (1, 512, 512, 16)])
def test_convt_blur_act_stages_match_plain_and_full_is_k4(cuda, N, Cin, Cout, H):
    """K5: each stage of K4's kernel against its plain version (load exactly
    0; conv, blur, full 1e-4 of max|ref|, sums of 9*Cin products in another
    order than cuDNN), and the full stage bitwise equal to K4."""
    a = _convt_args(N, Cin, Cout, H, None, cuda)
    ops.reset_launch_counts()
    for stage in ops.STAGES:
        got = ops.convt_blur_act_stage(stage, *a)
        ref = ops.convt_blur_act_stage_ref(stage, *a)
        assert got.shape == ref.shape
        if stage == "load":
            assert not got.any()
        else:
            assert _rel(got, ref) <= 1e-4, stage
    assert ops.convt_blur_act_stage.launches == dict.fromkeys(ops.STAGES, 1)
    assert torch.equal(ops.convt_blur_act_stage("full", *a), ops.convt_blur_act(*a))


def test_uint8_activations_on_the_card_match_the_cpu(cuda):
    """get_activations of uint8 pixels, dequantized on the card, against the
    CPU: 1e-4 of max|ref| (cuDNN sums the convolutions in another order)."""
    from rick_tpu_torch.metrics import get_activations, inception_from_params, inception_init_np

    params = inception_init_np(0)
    u8 = np.random.default_rng(3).integers(0, 256, (4, 3, 64, 64), dtype=np.uint8)
    got = get_activations(u8, 2, inception_from_params(params, device=cuda))
    want = get_activations(u8, 2, inception_from_params(params, device="cpu"))
    assert got.shape == (4, 2048) and _rel(torch.from_numpy(got), torch.from_numpy(want)) <= 1e-4


def test_small_evaluator_matches_the_cpu_path(cuda):
    """16px g_ema through K4 and K6 on the card and the plain chain on the
    CPU, into the cut Inception: activations within 1e-4 of max|ref|; the
    FID of the card's draws is finite; per chunk (2 chunks) K4 launched
    twice (2 upsample layers at 16px), K6 three times (conv1 and the second
    conv of 2 blocks), and K3 (f32) not at all."""
    from rick_tpu_torch.metrics import Evaluator, inception_init_np
    from rick_tpu_torch.nn import GeneratorConfig

    g = Generator(16, rng=torch.Generator().manual_seed(0))
    real = np.random.default_rng(0).integers(0, 256, (8, 3, 16, 16), dtype=np.uint8)
    kw = dict(fid_real_samples=real, inception_nsamples=8, batch_size=8, gen_batch=4,
              inception_params=inception_init_np(0), inception_stop_at="Mixed_6a", inception_resize_to=75)
    z = _rand((8, 512), 4)
    want = Evaluator(GeneratorConfig(16), device="cpu", **kw).activations(g, z)
    ev = Evaluator(GeneratorConfig(16), device=cuda, **kw)
    g_c = g.to(cuda)
    ops.reset_launch_counts()
    got = ev.activations(g_c, z.to(cuda))
    per_eval = {"convt_blur_act": 2 * 2, "modconv_act": 3 * 2, "modconv_epilogue": 0}
    assert {k: ops.launch_counts()[k] for k in per_eval} == per_eval
    assert _rel(got, want) <= 1e-4
    ops.reset_launch_counts()
    score = ev.compute_inception_score(g_c, kid=True)
    assert np.isfinite(score["fid"]) and np.isfinite(score["kid"])
    assert {k: ops.launch_counts()[k] for k in per_eval} == per_eval
