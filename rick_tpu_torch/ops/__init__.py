"""L0 ops: StyleGAN2 resampling, fused bias/activation, and the CUDA kernels.

Every kernel wrapper (`fused_bias_act`, `fused_bias_act_bwd`,
`modconv_epilogue`, `convt_blur_act`) takes its plain PyTorch version for CPU
tensors and launches its CUDA kernel for CUDA tensors; `KERNELS` lists them,
each with a `launches` count.  `fused_bias_act` and `modconv_epilogue` are
differentiable twice; `convt_blur_act` is forward only, as in JAX.
"""

from rick_tpu_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_kml, scaled_leaky_relu
from rick_tpu_torch.ops.fused_upsample import convt_blur_act, convt_blur_act_ref
from rick_tpu_torch.ops.kernels import (
    fused_bias_act,
    fused_bias_act_bwd,
    fused_bias_act_bwd_ref,
    fused_bias_act_ref,
    modconv_epilogue,
    modconv_epilogue_ref,
)
from rick_tpu_torch.ops.resample import (
    blur,
    downsample2d,
    make_kernel,
    upfirdn2d,
    upfirdn2d_general,
    upfirdn2d_separable,
    upsample2d,
)

KERNELS = (fused_bias_act, fused_bias_act_bwd, modconv_epilogue, convt_blur_act)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "blur",
    "convt_blur_act",
    "convt_blur_act_ref",
    "downsample2d",
    "fused_bias_act",
    "fused_bias_act_bwd",
    "fused_bias_act_bwd_ref",
    "fused_bias_act_ref",
    "fused_leaky_relu",
    "fused_leaky_relu_kml",
    "launch_counts",
    "make_kernel",
    "modconv_epilogue",
    "modconv_epilogue_ref",
    "reset_launch_counts",
    "scaled_leaky_relu",
    "upfirdn2d",
    "upfirdn2d_general",
    "upfirdn2d_separable",
    "upsample2d",
]
