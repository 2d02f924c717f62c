"""L2 models: StyleGAN2 generator / discriminator as `nn.Module`s whose state
dicts use the rosinality keys.  Port of `rick_tpu/nn`.  Beside them,
StyleGAN3-T's generator (`Generator3`, NVlabs' keys), which the JAX package
does not have."""

from rick_tpu_torch.nn.blocks import (
    Blur,
    ConstantInput,
    ConvLayer,
    EqualConv2d,
    EqualLinear,
    FusedLeakyReLU,
    ModulatedConv2d,
    NoiseInjection,
    PixelNorm,
    ResBlock,
    ScaledLeakyReLU,
    StyledConv,
    ToRGB,
    Upsample,
    minibatch_stddev,
    pixel_norm,
)
from rick_tpu_torch.nn.discriminator import Discriminator, DiscriminatorConfig
from rick_tpu_torch.nn.generator import Generator, GeneratorConfig
from rick_tpu_torch.nn.stylegan3 import Generator3, Generator3Config

__all__ = [
    "Blur",
    "ConstantInput",
    "ConvLayer",
    "Discriminator",
    "DiscriminatorConfig",
    "EqualConv2d",
    "EqualLinear",
    "FusedLeakyReLU",
    "Generator",
    "GeneratorConfig",
    "Generator3",
    "Generator3Config",
    "ModulatedConv2d",
    "NoiseInjection",
    "PixelNorm",
    "ResBlock",
    "ScaledLeakyReLU",
    "StyledConv",
    "ToRGB",
    "Upsample",
    "minibatch_stddev",
    "pixel_norm",
]
