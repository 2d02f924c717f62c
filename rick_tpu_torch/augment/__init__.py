"""ADA ("non-leaking") augmentation.  Port of `rick_tpu/augment`."""

from rick_tpu_torch.augment.ada import (
    SYM6,
    affine_draws,
    affine_from_draws,
    apply_affine,
    apply_color,
    augment,
    color_draws,
    color_from_draws,
    sample_affine,
    sample_color,
)

__all__ = [
    "SYM6",
    "affine_draws",
    "affine_from_draws",
    "apply_affine",
    "apply_color",
    "augment",
    "color_draws",
    "color_from_draws",
    "sample_affine",
    "sample_color",
]
