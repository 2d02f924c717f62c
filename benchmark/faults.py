"""Faults planted in the program's timed path, under which `correct` has to
come out false: the tests plant them on the CPU at a small size, and
`benchmark.control --fault` reads them on the card at the cell's size.

    state_unchanged  training: no step moves a parameter (Adam, the pruning
                     and the EMA do nothing)
    half_batch       training: each phase takes the first half of its batch;
                     evaluation: each chunk's statistics take half its samples
    altered          training: the D loss is off by 1% where it is made;
                     evaluation: the FID is off by 1% where it is made
    masks_altered    training: the Fisher round returns G's freeze masks inverted
    grad_negated     training: every gradient reaches Adam negated (as a
                     backward kernel that returned -g would hand it on)

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

TRAIN = ("state_unchanged", "half_batch", "altered", "masks_altered", "grad_negated")
EVAL = ("half_batch", "altered")


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Plant `fault` into the program for a cell of `kind` ("train", "fid")."""
    with contextlib.ExitStack() as stack:
        if kind == "train":
            import rick_tpu_torch.train as train
            from rick_tpu_torch.train import steps

            if fault == "state_unchanged":
                for name in ("adam_step", "prune_params", "ema"):
                    stack.enter_context(mock.patch.object(steps, name, lambda *a, **k: None))
            elif fault == "half_batch":
                original = train.run_iteration

                def half(state, tcfg, real_img, i, **kw):
                    half_cfg = dataclasses.replace(tcfg, batch=tcfg.batch // 2)
                    return original(state, half_cfg, real_img[: real_img.shape[0] // 2], i, **kw)

                stack.enter_context(mock.patch.object(train, "run_iteration", half))
            elif fault == "altered":
                loss = steps.d_logistic_loss
                stack.enter_context(mock.patch.object(steps, "d_logistic_loss", lambda *a: loss(*a) * 1.01))
            elif fault == "masks_altered":
                round_ = train.fisher_round

                def inverted(*a, **k):
                    g_freeze, g_prune, d_freeze, d_prune = round_(*a, **k)
                    return {n: 1.0 - m for n, m in g_freeze.items()}, g_prune, d_freeze, d_prune

                stack.enter_context(mock.patch.object(train, "fisher_round", inverted))
            elif fault == "grad_negated":
                adam = steps.adam_step
                stack.enter_context(mock.patch.object(
                    steps, "adam_step", lambda opt, params, grads: adam(opt, params, {n: -g for n, g in grads.items()})))
            else:
                raise KeyError(fault)
        elif kind == "fid":
            from rick_tpu_torch.metrics import Evaluator

            if fault == "half_batch":
                original = Evaluator.activations

                def half(self, g_ema, z, *, rng=None, noise=None):
                    n = z.shape[0] // 2
                    return original(self, g_ema, z[:n], rng=rng, noise=None if noise is None else [x[:n] for x in noise])

                stack.enter_context(mock.patch.object(Evaluator, "activations", half))
            elif fault == "altered":
                fid = Evaluator.fid
                stack.enter_context(mock.patch.object(Evaluator, "fid", lambda self, mu, cov: fid(self, mu, cov) * 1.01))
            else:
                raise KeyError(fault)
        else:
            raise KeyError(kind)
        yield
