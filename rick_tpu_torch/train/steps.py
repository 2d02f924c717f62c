"""Forward-only slice of `rick_tpu/train/steps.py`: the sample grids."""

from __future__ import annotations

import torch


@torch.inference_mode()
def sample_images(g_ema, sample_z: torch.Tensor, *, chunk: int = 25) -> torch.Tensor:
    """Deterministic sample grid from fixed latents, in chunks of `chunk`.
    Uses the registered constant noise buffers, so grids are reproducible."""
    outs = [g_ema([sample_z[i : i + chunk]])[0] for i in range(0, sample_z.shape[0], chunk)]
    return torch.cat(outs, dim=0)
