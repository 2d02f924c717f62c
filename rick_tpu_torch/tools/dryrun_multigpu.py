"""The data-parallel dry run: every multi-rank path once, at size 8.  The
port's counterpart of `__graft_entry__.dryrun_multichip`.

    python -m rick_tpu_torch.tools.dryrun_multigpu [--n 2] [--device cuda|cpu]

Starts N ranks with torchrun (`python -m torch.distributed.run --standalone
--nproc_per_node N`), each this module with `--rank`: NCCL on N cards (the
default; fewer cards than ranks raise), or gloo with `--device cpu`.  Each rank runs, at 8px (every code path: the
upsample StyledConv and the ToRGB skips, a ResBlock, the minibatch stddev
across ranks): one iteration of every phase (D, R1, G, path length) with
ADA and the EMA, over a global batch of one image per rank; a Fisher round
with its images sharded; a step under its masks; and an evaluation sharded
over the ranks, with Inception cut at Mixed_6a and a 75px input (as the JAX
dry run does; its real activations are random).  It checks that the
metrics and the FID are finite and that every rank holds the same state,
and prints one line per stage and rank.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 8


def _stage(rank: int, t0: float, name: str) -> None:
    print(f"[dryrun rank {rank} +{time.monotonic() - t0:6.1f}s] {name}", flush=True)


def _state_digest(state, group) -> None:
    """Raise unless every rank holds the same params, EMA and Adam moments."""
    from rick_tpu_torch.dist import all_gather_rows

    tensors = [t for m in (state.g, state.d, state.g_ema, state.d_ema) for t in m.state_dict().values()]
    tensors += [st[k] for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
                for k in ("exp_avg", "exp_avg_sq")]
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    digest = torch.stack([flat.sum(), (flat * torch.linspace(0, 1, flat.numel(), device=flat.device,
                                                             dtype=flat.dtype)).sum()])
    got = all_gather_rows(digest[None], group)
    if not all(torch.equal(g, got[0]) for g in got):
        raise RuntimeError(f"the ranks' states differ: {[g.tolist() for g in got]}")


def rank_main(device: str) -> None:
    """One rank of the dry run (under torchrun)."""
    if device == "cpu":
        torch.set_num_threads(1)
    t0 = time.monotonic()
    from rick_tpu_torch.dist import initialize_multihost, local_rows
    from rick_tpu_torch.metrics import Evaluator, inception_init_np
    from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
    from rick_tpu_torch.train import TrainConfig, fisher_round, init_train_state, replicate_train_state, run_iteration

    group, dev = initialize_multihost(device)
    rank, world = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    _stage(rank, t0, f"joined a {torch.distributed.get_backend(group)} group of {world} on {dev}")
    gcfg, dcfg = GeneratorConfig(size=SIZE), DiscriminatorConfig(size=SIZE)
    tcfg = TrainConfig(batch=world, augment=True, ada_margin=4, warmup_iter=0)
    state = init_train_state(gcfg, dcfg, tcfg, rng=torch.Generator(device=dev).manual_seed(rank), device=dev)
    replicate_train_state(state, group)  # the ranks drew other weights: rank 0's go to all
    host = np.random.default_rng(0)
    real = torch.from_numpy(host.standard_normal((world, 3, SIZE, SIZE)).astype(np.float32)).to(dev)
    _stage(rank, t0, "state built and replicated")

    m = run_iteration(state, tcfg, local_rows(real, group), 0, gen=torch.Generator(device=dev).manual_seed(2),
                      group=group)
    bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
    if bad:
        raise RuntimeError(f"non-finite metrics {bad}")
    _state_digest(state, group)
    _stage(rank, t0, "iteration 0 (D with ADA, R1, G, path length, EMA) ran; states equal: "
                     + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))

    noises = torch.from_numpy(host.standard_normal((world, 512)).astype(np.float32)).to(dev)
    reals = torch.from_numpy(host.standard_normal((world, 3, SIZE, SIZE)).astype(np.float32)).to(dev)
    gf, gp, df, dp = fisher_round(state.g_ema, state.d_ema, noises, reals, batch=world, fisher_quantile=50.0,
                                  prune_quantile=0.1, denom=float(world),
                                  gen=torch.Generator(device=dev).manual_seed(4), group=group)
    state.g_freeze, state.g_prune, state.d_freeze, state.d_prune = gf, gp, df, dp
    _stage(rank, t0, f"Fisher round, {world} images sharded over {world} ranks")

    m = run_iteration(state, tcfg, local_rows(real, group), 1, gen=torch.Generator(device=dev).manual_seed(5),
                      group=group)
    if not all(torch.isfinite(v).all() for v in m.values()):
        raise RuntimeError("non-finite metrics in the masked step")
    _state_digest(state, group)
    _stage(rank, t0, f"masked step ran; states equal; d {float(m['d']):.4f}")

    ev = Evaluator(gcfg, fid_real_samples=np.zeros((1, 3, SIZE, SIZE), np.float32), inception_nsamples=2 * world,
                   batch_size=world, gen_batch=2, inception_params=inception_init_np(0),
                   real_acts=host.standard_normal((2 * world, 768)), group=group, device=dev,
                   inception_stop_at="Mixed_6a", inception_resize_to=75)
    if ev.group is None:
        raise RuntimeError("the sharded evaluation was not taken")
    fid = ev.compute_inception_score(state.g_ema)["fid"]
    if not np.isfinite(fid):
        raise RuntimeError(f"non-finite FID {fid}")
    _stage(rank, t0, f"sharded evaluation ({2 * world} samples, {ev.n_chunks} chunk(s) of {ev.gen_batch} per rank): "
                     f"FID {fid:.3f}")
    torch.distributed.destroy_process_group()


def dryrun_multigpu(n: int = 2, device: str = "cuda") -> None:
    """Run the dry run on `n` ranks; raises if a rank fails."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards; {torch.cuda.device_count()} found")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
           "-m", "rick_tpu_torch.tools.dryrun_multigpu", "--rank", "--device", device]
    subprocess.run(cmd, check=True, timeout=1800)
    print(f"dryrun_multigpu({n}, {device}) OK", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2, help="ranks")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--rank", action="store_true", help="run as one rank (torchrun starts these)")
    args = p.parse_args(argv)
    if args.rank:
        rank_main(args.device)
    else:
        dryrun_multigpu(args.n, args.device)


if __name__ == "__main__":
    main()
