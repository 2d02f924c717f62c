"""Adam with beta1 = 0 and per-param step counts that advance only for
active params.  Port of `rick_tpu/train/adam.py`.

`rick_tpu` writes the update out with an `active` flag per leaf to reproduce
torch.optim.Adam under masking and warmup; here it is torch.optim.Adam
itself, over exactly the trainable params.  A param that is inactive in a
phase gets `grad = None` before `step()`, so torch skips it and its `step`
does not advance; an active param whose gradient is all zero (masked, or
unused by the loss) still steps, as its `active` flag makes it in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

Params = Dict[str, torch.nn.Parameter]


def make_adam(params: Params, *, lr: float, beta2: float, eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.0, beta2), eps=eps)


def adam_step(opt: torch.optim.Adam, params: Params, grads: Mapping[str, torch.Tensor]) -> None:
    """One step of the params named in `grads`; the others stay as they are,
    step count included."""
    for name, p in params.items():
        p.grad = grads.get(name)
    opt.step()
    for p in params.values():
        p.grad = None


def step_counts(opt: torch.optim.Adam, params: Params) -> Dict[str, int]:
    """Per-param step count (0 for a param that never stepped)."""
    return {n: int(opt.state[p]["step"]) if p in opt.state else 0 for n, p in params.items()}


def exp_avg_sq(opt: torch.optim.Adam, params: Params) -> Dict[str, torch.Tensor]:
    """Per-param second moment (zeros for a param that never stepped)."""
    return {
        n: opt.state[p]["exp_avg_sq"] if p in opt.state else torch.zeros_like(p)
        for n, p in params.items()
    }
