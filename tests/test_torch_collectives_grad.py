"""The differentiable collectives of ``repro_torch.dist.comm`` in gloo worlds
of 2 and 4 ranks, in float64.

Each rank holds its share of a function; its gradients must be those that
one process finds by differentiating the whole function -- the summed or
concatenated one -- and a replicated tensor's gradient must be bitwise the
same on every rank:

- ``rank_order_sum`` (backward: the identity);
- ``all_gather_cat`` with ``grad="slice"`` (replicated consumers) and with
  ``grad="sum"`` (each rank's consumer partial: ZeRO-3's gathered weights,
  whose gradient is a rank-order reduce-scatter);
- ``enter`` (identity; backward: the rank-order sum of partial gradients);
- Megatron's column- then row-parallel product built from ``enter`` and
  ``rank_order_sum``, with every leaf's gradient.

Both worlds run in spawned processes started together by one module
fixture, a ``FileStore`` each under the test's tmp dir, with a
process-group timeout and a join deadline.
"""

import datetime
import time

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
import torch.multiprocessing as mp

from repro_torch.dist import comm

WORLDS = (2, 4)
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300
D, F = 6, 8          # widths: rows split F = 2 * 4 so every world divides it
TOL = 1e-12


def _seeded(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


def _shares(world):
    """Every rank's inputs, as each rank (and the test) draws them."""
    return dict(
        x=[_seeded(10 + r, 3, D) for r in range(world)],     # per rank
        w=[_seeded(20 + r, 3, F) for r in range(world)],     # per-rank weight
        rep=_seeded(30, 3, D),                               # replicated
        w1=_seeded(40, D, F), w2=_seeded(41, F, D), v=_seeded(42, 3, D))


def _leaf(t):
    return t.clone().requires_grad_(True)


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        g = dist.group.WORLD
        s = _shares(world)
        out = {}
        # the rank-order sum: identity backward
        x = _leaf(s["x"][rank])
        y = comm.rank_order_sum(x, g)
        (s["w"][0][:, :D] * y).sum().backward()
        out["sum"] = (y.detach(), x.grad)
        # gather, replicated consumers: this rank's slice
        x = _leaf(s["x"][rank])
        y = comm.all_gather_cat(x, 1, g)
        (y ** 2).sum().backward()
        out["gather_slice"] = (y.detach(), x.grad)
        # gather, partial consumers: the reduce-scatter of their gradients
        x = _leaf(s["x"][rank][:, :2])
        y = comm.all_gather_cat(x, 1, g, grad="sum")
        (s["w"][rank][:, :2 * world] * y ** 2).sum().backward()
        out["gather_sum"] = (y.detach(), x.grad)
        # enter: the replicated input of a rank-local computation
        x = _leaf(s["rep"])
        (s["w"][rank][:, :D] * comm.enter(x, g) ** 2).sum().backward()
        out["enter"] = x.grad
        # Megatron: column-parallel w1, row-parallel w2, x replicated
        blk = slice(rank * F // world, (rank + 1) * F // world)
        x, w1, w2 = _leaf(s["rep"]), _leaf(s["w1"][:, blk]), \
            _leaf(s["w2"][blk])
        y = comm.rank_order_sum(torch.tanh(comm.enter(x, g) @ w1) @ w2, g)
        (s["v"] * y).sum().backward()
        out["mlp"] = (y.detach(), x.grad, w1.grad, w2.grad)
        out["collectives"] = comm.STATS["collectives"]
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [rank 0's results, ...]}, both worlds run together."""
    dirs = {w: tmp_path_factory.mktemp(f"coll-world{w}") for w in WORLDS}
    running = {w: mp.start_processes(_rank_main, args=(w, str(d)), nprocs=w,
                                     join=False, start_method="spawn")
               for w, d in dirs.items()}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while running:
            for w, ctx in list(running.items()):
                if ctx.join(timeout=0.5):
                    del running[w]
            if running and time.monotonic() > deadline:
                raise TimeoutError(f"worlds {sorted(running)} did not finish "
                                   f"in {JOIN_TIMEOUT_S} s")
    finally:
        for ctx in running.values():
            for p in ctx.processes:
                p.kill()
    return {w: [torch.load(d / f"rank{r}.pt") for r in range(w)]
            for w, d in dirs.items()}


def close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def same_on_every_rank(ranks, pick):
    first = pick(ranks[0])
    assert all(torch.equal(pick(r), first) for r in ranks[1:])


@pytest.mark.parametrize("world", WORLDS)
def test_rank_order_sum_backward_is_the_identity(worlds, world):
    s = _shares(world)
    xs = [_leaf(x) for x in s["x"]]
    y = sum(xs[1:], xs[0])
    (s["w"][0][:, :D] * y).sum().backward()
    for r, res in enumerate(worlds[world]):
        assert torch.equal(res["sum"][0], y.detach())
        close(res["sum"][1], xs[r].grad)
    same_on_every_rank(worlds[world], lambda res: res["sum"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_gather_backward_takes_the_ranks_slice(worlds, world):
    s = _shares(world)
    xs = [_leaf(x) for x in s["x"]]
    y = torch.cat(xs, dim=1)
    (y ** 2).sum().backward()
    for r, res in enumerate(worlds[world]):
        assert torch.equal(res["gather_slice"][0], y.detach())
        close(res["gather_slice"][1], xs[r].grad)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_with_partial_consumers_reduce_scatters(worlds, world):
    s = _shares(world)
    xs = [_leaf(x[:, :2]) for x in s["x"]]
    y = torch.cat(xs, dim=1)
    sum((w[:, :2 * world] * y ** 2).sum() for w in s["w"]).backward()
    for r, res in enumerate(worlds[world]):
        assert torch.equal(res["gather_sum"][0], y.detach())
        close(res["gather_sum"][1], xs[r].grad)


@pytest.mark.parametrize("world", WORLDS)
def test_enter_backward_sums_the_ranks_gradients(worlds, world):
    s = _shares(world)
    x = _leaf(s["rep"])
    sum((w[:, :D] * x ** 2).sum() for w in s["w"]).backward()
    for res in worlds[world]:
        close(res["enter"], x.grad)
    same_on_every_rank(worlds[world], lambda res: res["enter"])


@pytest.mark.parametrize("world", WORLDS)
def test_column_then_row_parallel_product(worlds, world):
    s = _shares(world)
    x, w1, w2 = _leaf(s["rep"]), _leaf(s["w1"]), _leaf(s["w2"])
    y = torch.tanh(x @ w1) @ w2
    (s["v"] * y).sum().backward()
    for r, res in enumerate(worlds[world]):
        blk = slice(r * F // world, (r + 1) * F // world)
        got_y, gx, gw1, gw2 = res["mlp"]
        close(got_y, y.detach())
        close(gx, x.grad)
        close(gw1, w1.grad[:, blk])
        close(gw2, w2.grad[blk])
        # forward 2 (sum, reduce-scatter's all-to-all) + backward sums
        assert res["collectives"] > 0
    same_on_every_rank(worlds[world], lambda res: res["mlp"][0])
    same_on_every_rank(worlds[world], lambda res: res["mlp"][1])
