"""Spectral norm and conditional norms (`gan_training/ops.py:6-127`) as
functions of their parameters.  Port of `rick_tpu/legacy/ops.py`."""

from __future__ import annotations

import torch


def spectral_norm_apply(weight: torch.Tensor, u: torch.Tensor, *, n_iter: int = 1, eps: float = 1e-12):
    """n power-iteration steps of spectral normalization: (w / sigma, new u).

    weight: (out, ...), flattened over its trailing dims; u: (out,), the
    left singular vector estimate carried as state, returned detached."""
    w = weight.reshape(weight.shape[0], -1)

    def l2n(v):
        return v / (torch.linalg.norm(v) + eps)

    for _ in range(n_iter):
        u = l2n(w @ l2n(w.T @ u))
    v = l2n(w.T @ u)
    sigma = u @ (w @ v)
    return weight / sigma, u.detach()


def _cond_norm(x, gamma, beta, dims, eps: float):
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)  # population variance, as jnp.var
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * gamma[:, :, None, None] + beta[:, :, None, None]


def cbatch_norm_apply(x, y_embed_gamma, y_embed_beta, *, eps: float = 1e-5):
    """Conditional batch norm: a per-sample affine over batch-normalized
    activations.  x: (N, C, H, W); gamma, beta: (N, C)."""
    return _cond_norm(x, y_embed_gamma, y_embed_beta, (0, 2, 3), eps)


def cinstance_norm_apply(x, y_embed_gamma, y_embed_beta, *, eps: float = 1e-5):
    """Conditional instance norm: as `cbatch_norm_apply`, normalized per
    sample and channel."""
    return _cond_norm(x, y_embed_gamma, y_embed_beta, (2, 3), eps)
