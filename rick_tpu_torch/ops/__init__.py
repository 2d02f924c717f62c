"""L0 ops: StyleGAN2 resampling, fused bias/activation, and the CUDA kernels.

Every kernel wrapper (`fused_bias_act`, `fused_bias_act_bwd`,
`modconv_epilogue`, `convt_blur_act`, `modconv_act`) takes its plain PyTorch
version for CPU tensors and launches its CUDA kernel for CUDA tensors;
`KERNELS` lists them, each with a `launches` count, and inside
`utils.trace.recording()` each call is counted, with its host time, under
`ops.<wrapper>`.  `fused_bias_act` and `modconv_epilogue` are
differentiable twice; `convt_blur_act` is forward only, as in JAX, and so is
`modconv_act` (K6: the plain StyledConv's conv and epilogue, for generation).
`fused_bias_act` and `modconv_epilogue` have a bf16 instantiation too
(`BF16_KERNELS`), counted apart in `launches_bf16`.
`convt_blur_act_stage` (K5, the stage ablation of `convt_blur_act`) runs only
in the ablation tool and counts its launches per stage.
"""

from rick_tpu_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_kml, scaled_leaky_relu
from rick_tpu_torch.ops.fused_upsample import (
    STAGES,
    convt_blur_act,
    convt_blur_act_ref,
    convt_blur_act_stage,
    convt_blur_act_stage_ref,
)
from rick_tpu_torch.ops.kernels import (
    fused_bias_act,
    fused_bias_act_bwd,
    fused_bias_act_bwd_ref,
    fused_bias_act_ref,
    modconv_epilogue,
    modconv_epilogue_ref,
)
from rick_tpu_torch.ops.modconv_act import modconv_act, modconv_act_ref
from rick_tpu_torch.ops.resample import (
    blur,
    downsample2d,
    make_kernel,
    upfirdn2d,
    upfirdn2d_general,
    upfirdn2d_separable,
    upsample2d,
)

KERNELS = (fused_bias_act, fused_bias_act_bwd, modconv_epilogue, convt_blur_act, modconv_act)
BF16_KERNELS = (fused_bias_act, modconv_epilogue)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in BF16_KERNELS:
        k.launches_bf16 = 0
    convt_blur_act_stage.launches = dict.fromkeys(STAGES, 0)


def launch_counts() -> dict:
    """{kernel: launches of its f32 form}."""
    return {k.__name__: k.launches for k in KERNELS}


def bf16_launch_counts() -> dict:
    """{kernel + "_bf16": launches of its bf16 instantiation}."""
    return {f"{k.__name__}_bf16": k.launches_bf16 for k in BF16_KERNELS}


__all__ = [
    "BF16_KERNELS",
    "KERNELS",
    "STAGES",
    "bf16_launch_counts",
    "blur",
    "convt_blur_act",
    "convt_blur_act_ref",
    "convt_blur_act_stage",
    "convt_blur_act_stage_ref",
    "downsample2d",
    "fused_bias_act",
    "fused_bias_act_bwd",
    "fused_bias_act_bwd_ref",
    "fused_bias_act_ref",
    "fused_leaky_relu",
    "fused_leaky_relu_kml",
    "launch_counts",
    "make_kernel",
    "modconv_act",
    "modconv_act_ref",
    "modconv_epilogue",
    "modconv_epilogue_ref",
    "reset_launch_counts",
    "scaled_leaky_relu",
    "upfirdn2d",
    "upfirdn2d_general",
    "upfirdn2d_separable",
    "upsample2d",
]
