"""The CUDA kernels' plain versions against the Pallas kernels (interpret mode
on the CPU, as tests/test_pallas.py and tests/test_fused_upsample.py run
them), the wrappers' dispatch and counters, and the import contract.

The kernels themselves are compared with their plain versions on the card by
tests/test_torch_cuda.py."""

import ast
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
    assert ops.launch_counts() == {
        "fused_bias_act": 0, "fused_bias_act_bwd": 0, "modconv_epilogue": 0, "convt_blur_act": 0,
    }


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


def test_build_command_names_every_source_and_the_hopper_target():
    names = [p.name for p in _build.sources()]
    assert names == ["convt_blur_act.cu", "fused_bias_act.cu", "modconv_epilogue.cu"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    out = _build.build_path()
    assert out.parent == _build.BUILD_DIR and out.parent.name == "rick_tpu_torch"
    assert out == _build.build_path()  # the name depends on the sources only
    assert set(_build.SIGNATURES) == {
        "rick_fused_bias_act", "rick_fused_bias_act_bwd", "rick_modconv_epilogue", "rick_convt_blur_act",
    }


def test_every_entry_point_is_defined_in_csrc_with_its_signature():
    for name, argtypes in _build.SIGNATURES.items():
        srcs = [p.read_text() for p in _build.sources() if f'extern "C" int {name}(' in p.read_text()]
        assert len(srcs) == 1, name
        decl = srcs[0].split(f'extern "C" int {name}(')[1].split(")")[0]
        assert decl.count(",") + 1 == len(argtypes), name


def test_import_leaves_jax_triton_and_cuda_alone():
    code = (
        "import sys, torch\n"
        "import rick_tpu_torch, rick_tpu_torch.ops, rick_tpu_torch.nn, rick_tpu_torch.ckpt\n"
        "import rick_tpu_torch.train, rick_tpu_torch.utils\n"
        "bad = [m for m in ('jax', 'triton', 'PIL') if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m.startswith('rick_tpu.') or m == 'rick_tpu']\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "from rick_tpu_torch.ops import _build\n"
        "assert _build._lib is None\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PACKAGE.parent, timeout=120)


def test_package_has_no_env_gates_and_no_jax():
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(m == "jax" or m.startswith(("jax.", "rick_tpu.")) or m == "rick_tpu" for m in names), path
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv"), f"{path}:{node.lineno}"
            assert not isinstance(node, ast.Try), f"{path}:{node.lineno}: no try/fallback in the port"
