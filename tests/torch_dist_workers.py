"""Ranks of the port's data-parallel tests: `run_ranks` starts N processes
(spawn), each joining a gloo group on the CPU from torchrun's variables
through `rick_tpu_torch.dist.initialize_multihost`, runs a worker function of
this module, and hands back its result.

This module imports neither jax nor `rick_tpu`: the ranks import it, and
only the test processes compare with `rick_tpu`.
"""

from __future__ import annotations

import hashlib
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rick_tpu_torch.ckpt import train_state_from_jax, train_state_to_jax
from rick_tpu_torch.dist import initialize_multihost, local_rows
from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
from rick_tpu_torch.train import TrainConfig, accumulate_fims, init_train_state, run_iteration
from rick_tpu_torch.train import steps as p_steps
from rick_tpu_torch.train.adam import exp_avg_sq, step_counts
from rick_tpu_torch.train.masks import d_trainable, g_trainable
from rick_tpu_torch.train.state import trainable_params


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, r, world, port, q, args, env):
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **env)
    torch.set_num_threads(1)
    try:
        q.put((r, True, fn(r, world, *args)))
    except BaseException:  # noqa: BLE001 - the traceback goes to the test process, which raises
        q.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 300.0, env=None):
    """[fn(rank, world, *args) for each rank], each in a process of its own
    with torchrun's variables set; a rank that raises or dies fails the
    call with its traceback."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, q, args, dict(env or {}))) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.time() + timeout
    try:
        while len(results) < world:
            try:
                r, ok, payload = q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.time() > deadline:
                    raise RuntimeError(f"ranks ended without a result (exit codes {dead}) or timed out")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{payload}")
            results[r] = payload
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
    return [results[r] for r in range(world)]


def group_world():
    group, _ = initialize_multihost("cpu")
    return group


# ---------------------------------------------------------------------------
# what the ranks return
# ---------------------------------------------------------------------------

SIZE = 8  # every layer kind: the upsample StyledConv and ToRGB skips, a ResBlock, the stddev
PG, PD = GeneratorConfig(size=SIZE), DiscriminatorConfig(size=SIZE)


PHASE_TOL = dict(grad=1e-5, v=1e-4, loss=1e-5)  # tests/test_torch_train.py's
ITER_TOL = dict(grad=1e-4, v=1e-2, loss=1e-4)
BASE = dict(batch=2, augment=False, warmup_iter=1, path_batch_shrink=1)  # path batch 2: one row per rank
REPLICATED = dict(BASE, path_batch_shrink=2)  # the recipe's path batch of 1
ADA = dict(BASE, augment=True, ada_margin=12)  # a static pad wider than the 8px image


def start_tree():
    """An 8px state two iterations in, as tests/test_torch_train.py makes
    its own: the all-zero params (biases, noise weights) drawn at 0.1 so
    that the bias and noise paths count, every second moment lifted to 1e-2
    of its tensor's largest; ADA at p 0.3 with 254 predictions pooled, so
    that the next D phase updates p."""
    tcfg = TrainConfig(**BASE)
    state = init_train_state(PG, PD, tcfg, rng=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in [p for m in (state.g, state.d) for p in m.parameters() if not p.any()]:
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    state.g_ema.load_state_dict(state.g.state_dict())
    state.d_ema.load_state_dict(state.d.state_dict())
    for i in range(2):
        run_iteration(state, tcfg, torch.randn((2, 3, SIZE, SIZE), generator=gen), i, gen=gen)
    for opt in (state.g_opt, state.d_opt):
        for st in opt.state.values():
            st["exp_avg_sq"] += 1e-2 * st["exp_avg_sq"].max()
    tree = train_state_to_jax(state)
    tree["ada_p"], tree["ada_stats"] = np.float32(0.3), np.asarray([40.0, 254.0], np.float32)
    return tree


def state_arrays(state) -> dict:
    """Every tensor of a TrainState that a step changes, as numpy: the four
    models, Adam's second moments and step counts, the path and ADA state."""
    out = {f"{name}.{k}": v.detach().numpy().copy()
           for name in ("g", "d", "g_ema", "d_ema") for k, v in getattr(state, name).state_dict().items()}
    for tag, opt, module, trainable in (("g", state.g_opt, state.g, g_trainable), ("d", state.d_opt, state.d,
                                                                                  d_trainable)):
        params = trainable_params(module, trainable)
        out.update({f"{tag}_opt.v.{k}": v.detach().numpy().copy() for k, v in exp_avg_sq(opt, params).items()})
        out.update({f"{tag}_opt.count.{k}": np.asarray(c) for k, c in step_counts(opt, params).items()})
    for k in ("mean_path_length", "ada_p", "ada_stats", "r_t"):
        out[k] = getattr(state, k).detach().numpy().copy()
    return out


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()} if isinstance(m, dict) else [float(v) for v in m]


def run_phase(state, tcfg: TrainConfig, phase: str, real, draws, group, i: int = 4):
    """One phase (or `run_iteration` at i with phase "iteration") on rank
    rows: real and draws are the global batch's.  Returns the metrics."""
    if phase == "iteration":
        return _metrics(run_iteration(state, tcfg, local_rows(real, group), i, draws=draws, group=group))
    if phase == "d":
        m, _ = p_steps.d_phase(state, tcfg, local_rows(real, group), p_steps.local_draws(draws["d"], group), False,
                               group)
        return _metrics({k: m[k] for k in ("d", "real_score", "fake_score", "ada_p", "r_t")})
    if phase == "r1":
        return [float(p_steps.r1_phase(state, tcfg, local_rows(real, group), False, group))]
    if phase == "g":
        return [float(p_steps.g_phase(state, tcfg, p_steps.local_draws(draws["g"], group), False, True, group))]
    replicated = group is not None and draws["path"].z1.shape[0] % dist.get_world_size(group) != 0
    pd = draws["path"] if replicated else p_steps.local_draws(draws["path"], group)
    return _metrics(p_steps.path_phase(state, tcfg, pd, False, group, replicated))


def digest(arrays: dict) -> str:
    """sha256 of every array's name, dtype, shape and bytes."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _run_case(tree, tcfg, phase, real, draws, i, group):
    state = train_state_from_jax(PG, PD, tree, tcfg=tcfg, device="cpu")
    m = run_phase(state, tcfg, phase, torch.from_numpy(real), draws, group, i)
    return m, state_arrays(state)


def phases_worker(r, world, tree, cases, want=None):
    """For each (TrainConfig kwargs, phase, real, draws, i, tolerance) of
    `cases`, from the state `tree` (rick_tpu's layout), as one rank of a
    gloo group: the metrics, a digest of the state after it, the small
    state (path and ADA), and on rank 0 the comparison (`compare_states`)
    of that state with the same case run by one process here, or with
    `want[k]` where given; the metrics of that reference.  (The states stay
    in the ranks: each is some 100 MB.)"""
    group = group_world()
    out = []
    for k, (tcfg_kw, phase, real, draws, i, tol) in enumerate(cases):
        tcfg = TrainConfig(**tcfg_kw)
        m, arrays = _run_case(tree, tcfg, phase, real, draws, i, group)
        res = {"metrics": m, "digest": digest(arrays),
               "small": {n: arrays[n] for n in ("mean_path_length", "ada_p", "ada_stats", "r_t")}}
        if r == 0:
            ref_m, ref = (None, want[k]) if want is not None else _run_case(tree, tcfg, phase, real, draws, i, None)
            res["ref_metrics"] = ref_m
            try:
                compare_states(arrays, ref, tcfg, tol)
                res["error"] = None
            except AssertionError as e:
                res["error"] = str(e)
        out.append(res)
    return out


def fims_worker(r, world, tree, cases, want=None, tol=(1e-4, 2e-5)):
    """For each (noises, reals, const_noise) of `cases`: accumulate_fims of
    the state's EMA models over the whole set, with the images sharded over
    the group where their count divides (fresh noise from a generator
    seeded 5 on every rank).  On rank 0 also: with `want` (a list of
    {name: FIM}), the largest excess of any entry over rtol * |want| + atol
    * max|want| of its tensor, (rtol, atol) = `tol`; without, one process's
    FIMs and the largest relative difference of any entry from them."""
    group = group_world()
    state = train_state_from_jax(PG, PD, tree, tcfg=TrainConfig(), device="cpu")
    out = []
    for k, (noises, reals, const_noise) in enumerate(cases):
        got = _fims(state, noises, reals, const_noise, group)
        res = {"digest": digest(got)}
        if r == 0 and want is not None:
            w = want[k]
            res["excess"] = max(float(np.max(np.abs(got[n] - w[n].reshape(got[n].shape))
                                             - tol[0] * np.abs(w[n]).reshape(got[n].shape)
                                             - tol[1] * np.abs(w[n]).max())) for n in got)
        elif r == 0:
            ref = _fims(state, noises, reals, const_noise, None)
            res["bitwise"] = digest(ref) == res["digest"]
            res["rel"] = max(float(np.max(np.abs(got[n] - ref[n]) / np.maximum(np.abs(ref[n]), 1e-30))) for n in ref)
            res["zeros_kept"] = all(np.array_equal(got[n] == 0, ref[n] == 0) for n in ref)
        out.append(res)
    return out


def _fims(state, noises, reals, const_noise, g):
    fg, fd = accumulate_fims(state.g_ema, state.d_ema, torch.from_numpy(noises), torch.from_numpy(reals), batch=2,
                             const_noise=const_noise, gen=torch.Generator().manual_seed(5), group=g)
    return {**{f"g.{k}": v.numpy() for k, v in fg.items()}, **{f"d.{k}": v.numpy() for k, v in fd.items()}}


def eval_worker(r, world, g_sd, real, incp, settings):
    """The Evaluator over the group (8 samples, chunks of 2: two per rank;
    KID and P&R), and on rank 0 the same evaluation in one process; then
    the chunk sizes and the path taken for each (n, gen_batch) of
    `settings`."""
    from rick_tpu_torch.metrics import Evaluator
    from rick_tpu_torch.nn import Generator

    group = group_world()
    g = Generator(SIZE, rng=torch.Generator().manual_seed(0)).eval()
    g.load_state_dict({k: torch.from_numpy(v) for k, v in g_sd.items()})
    kw = dict(fid_real_samples=real, inception_nsamples=8, batch_size=4, gen_batch=2, inception_params=incp, seed=3,
              device="cpu", compute_pr=True, inception_stop_at="Mixed_6a", inception_resize_to=75)

    def evaluate(grp):
        ev = Evaluator(PG, group=grp, **kw)
        score = ev.compute_inception_score(g, kid=True, pr=True)
        again = ev.compute_inception_score(g)  # a second call draws other samples
        mu, cov = ev.last_stats
        return {"score": score, "again": again["fid"], "mu": mu.numpy(), "cov": cov.numpy(),
                "chunks": (ev.gen_batch, ev.n_chunks, ev.group is not None)}

    out = {"sharded": evaluate(group)}
    if r == 0:
        out["one"] = evaluate(None)
    del kw["compute_pr"]
    out["settings"] = []
    for n, gb in settings:
        kw.update(inception_nsamples=n, gen_batch=gb, real_acts=np.zeros((4, 768)))
        ev = Evaluator(PG, group=group, **kw)
        out["settings"].append((ev.gen_batch, ev.n_chunks, ev.group is not None))
    kw.update(inception_nsamples=5, gen_batch=5)  # 5 samples do not divide over 2 ranks
    out["odd_fid"] = Evaluator(PG, group=group, **kw).compute_inception_score(g)["fid"]
    if r == 0:
        out["odd_fid_one"] = Evaluator(PG, **kw).compute_inception_score(g)["fid"]
    return out


def eval_blocks_worker(r, world, g_sd, incp, n, gen_batch):
    """The Evaluator sharded over the ranks at `n` samples and `gen_batch`:
    its chunking, and on rank 0 the gathered latents and per-layer noise
    of the ranks' draws and the sharded (mu, cov) against one process's."""
    from rick_tpu_torch.dist import all_gather_rows
    from rick_tpu_torch.metrics import Evaluator
    from rick_tpu_torch.nn import Generator

    group = group_world()
    g = Generator(SIZE, rng=torch.Generator().manual_seed(0)).eval()
    g.load_state_dict({k: torch.from_numpy(v) for k, v in g_sd.items()})
    kw = dict(fid_real_samples=np.zeros((1, 3, SIZE, SIZE), np.float32), real_acts=np.zeros((4, 768)),
              inception_nsamples=n, batch_size=4, gen_batch=gen_batch, inception_params=incp, seed=3,
              device="cpu", inception_stop_at="Mixed_6a", inception_resize_to=75)

    def run(grp):
        ev = Evaluator(PG, group=grp, **kw)
        ev.compute_inception_score(g)
        zs, noises = zip(*ev._chunk_draws(g, 0))  # the call's draws again
        z, noise = torch.cat(zs), [torch.cat(ns) for ns in zip(*noises)]
        draws = [all_gather_rows(t, ev.group) for t in (z, *noise)]
        return ev, draws, [t.numpy() for t in ev.last_stats]

    ev, draws, stats = run(group)
    out = {"chunks": (ev.gen_batch, ev.n_chunks, ev._block, ev.group is not None)}
    if r == 0:
        ev1, draws1, stats1 = run(None)
        out["one_chunks"] = (ev1.gen_batch, ev1.n_chunks, ev1._block, ev1.group is not None)
        out["draws_equal"] = len(draws) == len(draws1) and all(torch.equal(a, b) for a, b in zip(draws, draws1))
        out["stats_err"] = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(stats, stats1)]
    return out


def helpers_worker(r, world, x, w, u, a):
    """The dist helpers on this rank, and minibatch_stddev of this rank's
    rows of x (scaled by the parameter a): the output rows, the gradient of
    sum(w * out) with respect to the rows (kept in the graph), and the
    gradients of sum(u * that gradient^2) with respect to the rows and a."""
    from rick_tpu_torch import dist as rd
    from rick_tpu_torch.nn.blocks import minibatch_stddev

    group = group_world()
    out = {"world": rd.world_size(group), "rank": rd.rank(group), "main": rd.is_main_process(group),
           "slice": rd.process_batch_slice(4, group), "local_batch": rd.local_batch_size(6, group)}
    for bad in (3, 5):
        try:
            rd.process_batch_slice(bad, group)
            out[f"raises_{bad}"] = False
        except ValueError:
            out[f"raises_{bad}"] = True
    t = torch.tensor([float(r + 1), 10.0 * (r + 1)])
    out["sum"], out["mean"] = rd.reduce_sum(t, group).numpy(), rd.reduce_mean(t, group).numpy()
    out["gathered"] = rd.all_gather_rows(t[None], group).numpy()
    b = torch.full((2,), float(r))
    rd.replicate([b], group)
    out["broadcast"] = b.numpy()
    av = [torch.tensor([float(r)]), torch.tensor([[2.0 * r]])]
    rd.average_(av, group)
    out["average"] = [v.numpy() for v in av]

    xa = torch.from_numpy(local_rows(torch.from_numpy(x), group).numpy().copy()).requires_grad_(True)
    pa = torch.tensor(float(a), requires_grad=True)
    y = minibatch_stddev(xa * pa, stddev_group=4, group=group)
    (gx,) = torch.autograd.grad((y * local_rows(torch.from_numpy(w), group)).sum(), xa, create_graph=True)
    second = (gx.pow(2) * local_rows(torch.from_numpy(u), group)).sum()
    ggx, gga = torch.autograd.grad(second, (xa, pa))
    out.update(y=y.detach().numpy(), gx=gx.detach().numpy(), ggx=ggx.numpy(), gga=float(gga))
    try:  # splits and a group do not combine
        minibatch_stddev(xa, stddev_group=2, splits=2, group=group)
        out["splits_raise"] = False
    except ValueError:
        out["splits_raise"] = True
    return out


def cli_worker(r, world, argv):
    """`python -m rick_tpu_torch.cli.train` as one rank on the CPU: its
    summary and what it printed."""
    import contextlib
    import io

    from rick_tpu_torch.cli import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = train.main(argv, device="cpu")
    return summary, out.getvalue()


def compare_states(got: dict, want: dict, tcfg: TrainConfig, tol: dict) -> None:
    """`state_arrays` of a port state against a reference one, as
    tests/test_torch_train.py compares the port with rick_tpu: each param
    entry within 1e-6 of its tensor's max|ref| plus, where it stepped, the
    propagation through Adam of a gradient error of tol["grad"] times the
    tensor's largest gradient (plus 1% of lr), an EMA copy (1 - accum) of
    that; Adam's v within tol["v"] of max|ref|; step counts equal; the path
    and ADA state within tol["loss"]."""
    assert got.keys() == want.keys()
    for k, ref in want.items():
        model, _, name = k.partition(".")
        if model in ("g", "d", "g_ema", "d_ema"):
            opt = model[0] + "_opt"
            beta2, lr = (tcfg.g_beta2, tcfg.g_lr) if model[0] == "g" else (tcfg.d_beta2, tcfg.d_lr)
            share = 1.0 - tcfg.ema_accum if model.endswith("_ema") else 1.0
            count = int(want.get(f"{opt}.count.{name}", 0))
            atol = 1e-6 * float(np.abs(ref).max())
            if count:
                v = want[f"{opt}.v.{name}"]
                v_hat = v / (1.0 - beta2**count)
                step = 1e-2 * lr + lr * tol["grad"] * np.sqrt(v.max() / (1.0 - beta2)) / (np.sqrt(v_hat) + 1e-8)
                atol = atol + share * step
            excess = np.abs(got[k] - ref) - atol
            assert np.all(excess <= 0), f"{k}: {int((excess > 0).sum())} entries, up to {excess.max():.3e} over"
        elif ".count." in k:
            assert int(got[k]) == int(ref), k
        elif ".v." in k:
            np.testing.assert_allclose(got[k], ref, rtol=0, atol=tol["v"] * float(np.abs(ref).max()), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref, rtol=tol["loss"], atol=tol["loss"], err_msg=k)

