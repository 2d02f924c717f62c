"""The port's data-parallel helpers (`rick_tpu_torch.dist`) on the CPU:
world, rank and row slicing in one process and on 2 gloo ranks, the
launch's environment, `--n_devices`, and the minibatch stddev of D taken
across 2 ranks (a twice-differentiable gather) against the same function on
the whole batch in one process: forward, gradient and double gradient."""

import numpy as np
import pytest
import torch

from rick_tpu_torch import dist as rd
from rick_tpu_torch.cli import train
from rick_tpu_torch.nn.blocks import minibatch_stddev
from tests.torch_dist_workers import helpers_worker, run_ranks
from tests.torch_port_helpers import close, one_torch_thread, rand  # noqa: F401

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launch(monkeypatch):
    for v in TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_single_process_helpers_are_the_identity(no_launch):
    x = torch.arange(6.0).reshape(3, 2)
    assert (rd.world_size(None), rd.rank(None), rd.is_main_process(None)) == (1, 0, True)
    assert rd.process_batch_slice(7, None) == (0, 7) and rd.local_batch_size(7, None) == 7
    assert rd.local_rows(x, None) is x and rd.all_gather_rows(x, None) is x
    assert torch.equal(rd.reduce_sum(x, None), x) and torch.equal(rd.reduce_mean(x, None), x)
    assert rd.initialize_multihost("cpu") == (None, torch.device("cpu"))


def test_env_detection(no_launch):
    assert rd.launched_world_size() is None
    no_launch.setenv("WORLD_SIZE", "1")  # torchrun --nproc_per_node 1: a group of one
    assert rd.launched_world_size() == 1
    no_launch.setenv("WORLD_SIZE", "4")
    assert rd.launched_world_size() == 4


def test_more_local_ranks_than_cards_raise_unless_gloo_is_asked(no_launch):
    """NCCL takes one rank per card; the CPU here has no card at all."""
    no_launch.setenv("WORLD_SIZE", "2")
    no_launch.setenv("LOCAL_WORLD_SIZE", "2")
    no_launch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        rd.initialize_multihost("cuda")


@pytest.mark.parametrize("n_devices,world,ok", [(0, None, True), (1, None, True), (2, None, False),
                                                (0, "2", True), (2, "2", True), (3, "2", False)])
def test_n_devices_is_zero_or_the_world_size(n_devices, world, ok, no_launch):
    if world:
        no_launch.setenv("WORLD_SIZE", world)
    args = train.build_parser().parse_args(["--n_devices", str(n_devices)])
    if ok:
        train.check_n_devices(args)
    else:
        with pytest.raises(ValueError, match="torchrun"):
            train.check_n_devices(args)


# ---------------------------------------------------------------------------
# 2 ranks: the helpers and the minibatch stddev across them
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks():
    """x (4, 8, 4, 4): a group of 4 across 2 ranks of 2 rows; w and u
    weigh the output and the squared gradient; a scales x (a parameter)."""
    x, w, u = rand((4, 8, 4, 4), 1), rand((4, 9, 4, 4), 2), rand((4, 8, 4, 4), 3)
    return (x, w, u, 1.3), run_ranks(helpers_worker, 2, x, w, u, 1.3)


def test_ranks_know_their_place(two_ranks):
    _, outs = two_ranks
    for r, o in enumerate(outs):
        assert (o["world"], o["rank"], o["main"]) == (2, r, r == 0)
        assert o["slice"] == (2 * r, 2) and o["local_batch"] == 3
        assert o["raises_3"] and o["raises_5"]  # a global batch that does not divide raises


def test_collectives_across_two_ranks(two_ranks):
    _, outs = two_ranks
    for o in outs:
        np.testing.assert_array_equal(o["sum"], [3.0, 30.0])
        np.testing.assert_array_equal(o["mean"], [1.5, 15.0])
        np.testing.assert_array_equal(o["gathered"], [[1.0, 10.0], [2.0, 20.0]])
        np.testing.assert_array_equal(o["broadcast"], [0.0, 0.0])
        np.testing.assert_array_equal(o["average"][0], [0.5])
        np.testing.assert_array_equal(o["average"][1], [[1.0]])


def _global(x, w, u, a):
    xa = torch.from_numpy(x).requires_grad_(True)
    pa = torch.tensor(float(a), requires_grad=True)
    y = minibatch_stddev(xa * pa, stddev_group=4)
    (gx,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xa, create_graph=True)
    ggx, gga = torch.autograd.grad((gx.pow(2) * torch.from_numpy(u)).sum(), (xa, pa))
    return y.detach(), gx.detach(), ggx, float(gga)


def test_minibatch_stddev_across_ranks_is_the_global_batchs(two_ranks):
    """Each rank's output rows, the gradient of the global weighted sum
    with respect to its rows, and the double gradient (R1's): against one
    process on the whole batch, within 1e-6 of max|ref| (f32 sums of 2
    partial sums against one); the parameter's double gradient is the sum
    over the ranks of theirs."""
    (x, w, u, a), outs = two_ranks
    y, gx, ggx, gga = _global(x, w, u, a)
    for r, o in enumerate(outs):
        rows = slice(2 * r, 2 * r + 2)
        close(o["y"], y[rows], rtol=1e-6, atol_frac=1e-6)
        close(o["gx"], gx[rows], rtol=1e-6, atol_frac=1e-6)
        close(o["ggx"], ggx[rows], rtol=1e-6, atol_frac=1e-6)
    np.testing.assert_allclose(sum(o["gga"] for o in outs), gga, rtol=1e-5)


def test_a_local_stddev_would_differ(two_ranks):
    """The check above has teeth: the statistics of a rank's 2 rows alone
    are not the global 4's."""
    (x, *_), outs = two_ranks
    local = minibatch_stddev(torch.from_numpy(x[:2]), stddev_group=4)
    assert not np.allclose(local.numpy(), outs[0]["y"], atol=1e-3)


def test_stddev_splits_with_a_group_raise(two_ranks):
    """The gathered batch is rank-major: sub-batches of it would mix the
    ranks' splits, so splits != 1 with a group raises."""
    _, outs = two_ranks
    assert all(o["splits_raise"] for o in outs)


def test_dryrun_multigpu_defaults_to_the_card(no_launch):
    """Without --device the dry run asks for N cards (NCCL); the CPU here
    has none, so it raises before it starts a rank."""
    from rick_tpu_torch.tools import dryrun_multigpu

    with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
        dryrun_multigpu.main(["--n", "2"])


def test_dryrun_multigpu_on_two_cpu_ranks(capsys):
    """The dry run through torchrun at N = 2: every stage on each rank
    (the phases with ADA, the sharded Fisher round, the masked step, the
    sharded evaluation), the ranks' states equal."""
    from rick_tpu_torch.tools import dryrun_multigpu

    dryrun_multigpu.dryrun_multigpu(2, "cpu")
    assert "dryrun_multigpu(2, cpu) OK" in capsys.readouterr().out
