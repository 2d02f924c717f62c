"""The model FLOPs of each unit of a cell's work, counted once from the plain
reference's shapes and kept as data (`flops/<config>.<traffic>.json`), so
that they read the same work whatever implements it.

The counter is the formulas of `torch.utils.flop_counter` over the
reference on the `meta` device: 2 FLOPs per multiply-add of every matrix
product and convolution, forward, backward and the double backward of R1
and path length; a transposed convolution counts 2 x batch x Cin x Cout x
9 x its input pixels, as the roofline's `convt_ops`.  Elementwise work,
resizes, pools and the Fréchet distance's eigendecompositions are not
counted.

    python3 -m benchmark.flops          # rewrite the data files of BENCHMARK.json's cells
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from benchmark import spec
from benchmark.reference import stylegan2
from benchmark.reference import train as ref_train
from benchmark.reference.inception import InceptionPool3, leaves

META = "meta"


class _Counter(TorchDispatchMode):
    """FlopCounterMode's arithmetic (its registry of formulas) without its
    module hooks, which refuse a gradient taken with respect to an input."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def count(fn) -> int:
    with _Counter() as c:
        fn()
    return int(c.total)


def _draws(g, batch: int, path: bool = False) -> dict:
    with torch.device(META):
        draws = dict(z1=torch.empty(batch, g.style_dim), z2=torch.empty(batch, g.style_dim),
                     inject=torch.full((), g.n_latent // 2),
                     noise=[torch.empty(batch, 1, g.noise_res(j), g.noise_res(j)) for j in range(g.num_layers)])
        if path:
            draws["noise_img"] = torch.empty(batch, 3, g.size, g.size)
    return draws


def _grads(loss, params) -> None:
    torch.autograd.grad(loss, list(params), allow_unused=True)


def train_flops(cfg: dict, t: dict) -> dict:
    """FLOPs of each phase kind (d, r1, g, path) and of one Fisher round."""
    g, d = stylegan2.models(cfg, META)
    gp = [p for n, p in g.named_parameters() if ref_train.g_trainable(n)]
    dp = [p for n, p in d.named_parameters() if ref_train.d_trainable(n)]
    b, size = t["batch"], cfg["size"]
    real = torch.empty(b, 3, size, size, device=META)
    mpl = torch.zeros((), device=META)
    path_b = max(1, b // t["path_batch_shrink"])

    def fisher():
        for _ in range(t["num_fisher_img"]):
            gl, dl = ref_train.fisher_losses(g, d, torch.empty(1, g.style_dim, device=META), real[:1],
                                             _draws(g, 1)["noise"])
            _grads(gl, g.parameters())
            _grads(dl, d.parameters())

    return {
        "d": count(lambda: _grads(ref_train.d_phase_loss(g, d, real, _draws(g, b)), dp)),
        "r1": count(lambda: _grads(ref_train.r1_phase_loss(d, real, t["r1"], t["d_reg_every"])[0], dp)),
        "g": count(lambda: _grads(ref_train.g_phase_loss(g, d, _draws(g, t["batch"])), gp)),
        "path": count(lambda: _grads(ref_train.path_phase_loss(g, _draws(g, path_b, True), mpl, t["path_regularize"],
                                                               t["g_reg_every"])[0], gp)),
        "fisher_round": count(fisher),
    }


def eval_flops(cfg: dict, t: dict) -> dict:
    """FLOPs of one evaluation: generation and Inception of every sample,
    and the covariance of the activations."""
    g, _ = stylegan2.models(cfg, META)
    with torch.device(META):
        inception = InceptionPool3({n: torch.empty(shape) for n, shape, _, _ in leaves()})
        acts = torch.empty(t["inception_nsamples"], 2048)
    gb = t["gen_batch"]
    draws = _draws(g, gb)

    @torch.no_grad()
    def chunk():
        inception(g(draws["z1"], draws["noise"]))

    return {"evaluation": count(chunk) * (t["inception_nsamples"] // gb) + count(lambda: acts.T @ acts)}


KINDS = {"train": train_flops, "fid": eval_flops}


def main(argv=None) -> int:
    bench = spec.load_benchmark()
    out_dir = spec.ROOT / "flops"
    out_dir.mkdir(exist_ok=True)
    for cell in bench["workloads"]:
        cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
        counts = KINDS[traffic["kind"]](cfg, traffic)
        path = out_dir / f"{cell['config']}.{cell['traffic']}.json"
        path.write_text(json.dumps(counts, indent=1) + "\n")
        print(path.name, counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
