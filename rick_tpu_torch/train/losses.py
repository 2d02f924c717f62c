"""GAN losses and the path-length statistics.  Port of `rick_tpu/train/losses.py`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rick_tpu_torch.dist import all_gather_rows


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-real).mean() + softplus(fake).mean()."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-fake).mean()."""
    return F.softplus(-fake_pred).mean()


def path_stats(grad_latents: torch.Tensor, mean_path_length: torch.Tensor, *, decay: float = 0.01, group=None):
    """Path-length statistics from d(sum(fake * noise))/d(latents), shape
    (B, n_latent, style_dim): lengths = sqrt(mean over layers of the summed
    squares); the running mean moves by `decay` towards their mean; penalty =
    mean((lengths - new mean)^2), differentiated through the new mean as in
    JAX.  Returns (penalty, the new mean detached, lengths).

    With a process `group`, the rows are this rank's of the global path
    batch: the new mean is that of the global batch's lengths, gathered
    differentiably, and the penalty the mean over this rank's rows (the
    mean over the ranks of the penalties, and of their gradients, is the
    global one)."""
    lengths = torch.sqrt((grad_latents * grad_latents).sum(dim=2).mean(dim=1))
    path_mean = mean_path_length + decay * (all_gather_rows(lengths, group).mean() - mean_path_length)
    penalty = ((lengths - path_mean) ** 2).mean()
    return penalty, path_mean.detach(), lengths
