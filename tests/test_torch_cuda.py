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

from rick_tpu_torch import ops
from rick_tpu_torch.nn import Discriminator, Generator

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


@pytest.mark.parametrize("N,Cin,Cout,H", [(2, 8, 8, 8), (1, 16, 8, 4), (3, 8, 16, 16), (1, 8, 256, 8),
                                          (2, 40, 48, 5), (1, 512, 64, 4), (2, 32, 32, 33)])
@pytest.mark.parametrize("noise_batch", [None, 1], ids=["noise_B", "noise_1"])
def test_convt_blur_act_kernel_matches_plain(cuda, N, Cin, Cout, H, noise_batch):
    a = _convt_args(N, Cin, Cout, H, noise_batch, cuda)
    # sums of 9*Cin products in another order than cuDNN: 1e-4
    assert _rel(ops.convt_blur_act(*a), ops.convt_blur_act_ref(*a)) <= 1e-4
    a[4] = None
    assert _rel(ops.convt_blur_act(*a, use_act=False), ops.convt_blur_act_ref(*a, use_act=False)) <= 1e-4


def test_kernels_raise_under_autograd_and_on_bad_input(cuda):
    x = torch.randn((2, 4, 3, 3), device=cuda, requires_grad=True)
    b = torch.zeros(4, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.fused_bias_act(x, b)
    with torch.no_grad():
        ops.fused_bias_act(x, b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_bias_act(torch.randn((4, 2, 3, 3), device=cuda).transpose(0, 1), b)
    with pytest.raises(ValueError, match="dtype"):
        ops.fused_bias_act(x.detach().double(), b)
    with pytest.raises(ValueError, match="bias"):
        ops.fused_bias_act(x.detach(), torch.zeros(5, device=cuda))


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
        got, got_f = g_c([z1.to(cuda), z2.to(cuda)], inject_index=3, return_feats=True)
        got_s = d_c(want.to(cuda))[0]
    assert all(v > 0 for v in ops.launch_counts().values())
    for a, b in [(got, want), (got_s, want_s)] + list(zip(got_f, want_f)):
        assert _rel(a, b) <= 1e-4
