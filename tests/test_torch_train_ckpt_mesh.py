"""Checkpoints of a sharded train state, and the training launcher on a
mesh, in gloo worlds on the CPU.

A world of 2 ranks (mesh ``(1, 2)``) and one of 4 (``(2, 2)``), both
tensor-parallel, run together from one module fixture, a ``FileStore``
each under the test's tmp dir, with a process-group timeout and a join
deadline:

- each restores a checkpoint the reference wrote (``repro.checkpoint``)
  and one a single device of the port wrote, onto its mesh;
- ``(1, 2)`` trains 2 steps and writes checkpoint A; ``(2, 2)`` restores
  A, trains 2 steps from the same weights and writes B, which ``(1, 2)``
  restores;
- on ``(1, 2)`` a run of 2 steps, a checkpoint, a fresh state restored
  from it and 2 more steps is bitwise the unbroken 4 steps.

Every state restored on a mesh, gathered, is bitwise the one written; the
reference and one device of the port restore A and B bitwise too. Then
``repro_torch.launch.train --model-parallel 2`` runs in a two-process gloo
world made from the environment as torchrun makes it: 4 steps, a
checkpoint every 2, and a second launch on a copy of step 2 resumes there,
at the data cursor, and writes a step-4 checkpoint bitwise the first
launch's.
"""

import datetime
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
import torch.multiprocessing as mp

from repro_torch import configs as TC
from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.launch import train as launch_train
from repro_torch.launch.sharding import gather_tensor, train_state_shardings
from repro_torch.models import build_model, shard_state_dict
from repro_torch.models.convert import stack_like_reference
from repro_torch.train.step import (init_train_state, load_reference_tree,
                                    make_train_step, reference_like,
                                    reference_shardings, reference_tree,
                                    train_state_specs)
from test_torch_lm_sharded_train import (numpy_weights, torch_batch,
                                         train_batch)

ARCH = "qwen3_4b"
WORLDS = {2: 2, 4: 2}          # world size -> "model" axis
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 400
WAIT_S = 120
CPU = "cpu"
KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


def cfg_of():
    return TC.get(ARCH).reduced()


def fresh(cfg, mesh=None):
    """(model, state, step fn) from the numpy weights."""
    model = build_model(cfg, device=CPU, mesh=mesh)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    whole = {n: torch.from_numpy(w) for n, w in numpy_weights(cfg).items()}
    mine = whole if mesh is None else shard_state_dict(cfg, whole, mesh)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(mine[n])
    return model, state, make_train_step(model, **KW)


def train(state, step, start, stop):
    cfg = cfg_of()
    for i in range(start, stop):
        step(state, torch_batch(train_batch(cfg, i)))
    return state


def whole_tree(state, shardings, mesh):
    """The state in the reference's layout, every leaf gathered whole."""
    def g(tree, specs):
        return {n: gather_tensor(t.detach(), specs[n], mesh).numpy().copy()
                for n, t in tree.items()}
    flat = dict(params=g(state.params, shardings.params),
                mu=g(state.opt.mu, shardings.opt.mu),
                nu=g(state.opt.nu, shardings.opt.nu))
    return {k: stack_like_reference(v) for k, v in flat.items()} | dict(
        count=int(state.opt.count), step=int(state.step))


def _rank_main(rank, world, out_dir, dirs):
    import torch.distributed as dist
    from repro_torch.ft import ElasticMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        cfg = cfg_of()
        mesh = ElasticMesh(WORLDS[world], device=CPU).current()
        model, state, step = fresh(cfg, mesh)
        shardings = train_state_shardings(mesh, train_state_specs(model))
        on_disk = reference_shardings(shardings)
        like = reference_like(train_state_specs(model))

        def restored(directory, sharded=True):
            _, st, _ = fresh(cfg, mesh)
            s = latest_step(directory)
            if sharded:
                tree, extra = restore_pytree(directory, s, like,
                                             sharding_tree=on_disk,
                                             mesh=mesh)
                load_reference_tree(st, tree)
            else:               # whole leaves, cut by load_reference_tree
                tree, extra = restore_pytree(directory, s, like)
                load_reference_tree(st, tree, shardings, mesh)
            return whole_tree(st, shardings, mesh), extra

        def wait_for(directory):
            deadline = time.monotonic() + WAIT_S
            while latest_step(directory) is None:
                if time.monotonic() > deadline:
                    raise TimeoutError(directory)
                time.sleep(0.2)

        out = {"coord": tuple(mesh.get_coordinate())}
        out["from_reference"] = restored(dirs["ref"])
        out["from_one_device"] = restored(dirs["one"], sharded=False)
        if world == 2:
            train(state, step, 0, 2)
            out["wrote"] = whole_tree(state, shardings, mesh)
            save_pytree(dirs["a"], 2, reference_tree(state),
                        extra={"data_step": 2}, sharding_tree=on_disk,
                        mesh=mesh)
            # chunked: 2 steps, checkpoint, restore into a fresh state, 2
            # more; against 4 unbroken steps
            train(state, step, 2, 4)
            save_pytree(dirs["chunk"], 2, reference_tree(
                train(fresh(cfg, mesh)[1], step, 0, 2)), sharding_tree=on_disk,
                mesh=mesh)
            _, st, _ = fresh(cfg, mesh)
            tree, _ = restore_pytree(dirs["chunk"], 2, like,
                                     sharding_tree=on_disk, mesh=mesh)
            load_reference_tree(st, tree)
            train(st, step, 2, 4)
            out["chunked"] = all(
                torch.equal(a, b) for mine, theirs in (
                    (st.params, state.params), (st.opt.mu, state.opt.mu),
                    (st.opt.nu, state.opt.nu))
                for a, b in zip(mine.values(), theirs.values()))
            wait_for(dirs["b"])
            out["from_other_mesh"] = restored(dirs["b"])
        else:
            wait_for(dirs["a"])
            out["from_other_mesh"] = restored(dirs["a"])
            train(state, step, 0, 2)
            out["wrote"] = whole_tree(state, shardings, mesh)
            save_pytree(dirs["b"], 2, reference_tree(state),
                        extra={"data_step": 2}, sharding_tree=on_disk,
                        mesh=mesh)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _launch_rank(rank, port, argv, log):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import contextlib
    with open(f"{log}.{rank}", "w") as f, contextlib.redirect_stdout(f):
        state = launch_train.main(argv)
    torch.save({"step": int(state.step),
                "params": {n: p.detach() for n, p in state.params.items()}},
               f"{log}.{rank}.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(ctxs, what):
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while ctxs:
            for k, ctx in list(ctxs.items()):
                if ctx.join(timeout=0.5):
                    del ctxs[k]
            if ctxs and time.monotonic() > deadline:
                raise TimeoutError(f"{what} {sorted(ctxs)} did not finish "
                                   f"in {JOIN_TIMEOUT_S} s")
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                p.kill()


def _reference_state(cfg):
    """The reference's state after one step of its own, from the numpy
    weights (JAX is imported here and in the tests, not at the top, so the
    spawned ranks do not load it)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as RC
    from repro.models import build_model as ref_build
    from repro.train import step as RS
    from repro.train.optimizer import adamw_init
    rcfg = RC.get(ARCH).reduced()
    model = ref_build(rcfg)
    params = jax.tree.map(jnp.asarray,
                          stack_like_reference(numpy_weights(cfg)))
    state = RS.TrainState(params=params, opt=adamw_init(params),
                          step=jnp.zeros((), jnp.int32))
    step = jax.jit(RS.make_train_step(model, **KW))
    state, _ = step(state, {k: jnp.asarray(v)
                            for k, v in train_batch(cfg, 0).items()})
    return model, state


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from repro.checkpoint import save_pytree as ref_save
    root = tmp_path_factory.mktemp("ckpt-mesh")
    dirs = {k: str(root / k) for k in ("ref", "one", "a", "b", "chunk")}
    cfg = cfg_of()
    rmodel, rstate = _reference_state(cfg)
    ref_save(dirs["ref"], 1, rstate, extra={"data_step": 1})
    _, one, step = fresh(cfg)
    train(one, step, 0, 3)
    save_pytree(dirs["one"], 3, reference_tree(one), extra={"data_step": 3})
    outs = {w: tmp_path_factory.mktemp(f"ckpt-world{w}") for w in WORLDS}
    _join({w: mp.start_processes(_rank_main, args=(w, str(d), dirs),
                                 nprocs=w, join=False, start_method="spawn")
           for w, d in outs.items()}, "worlds")
    ranks = {w: [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(w)] for w, d in outs.items()}
    return dict(dirs=dirs, ranks=ranks, rmodel=rmodel, rstate=rstate,
                one=one, cfg=cfg)


def trees_equal(got, want):
    """Bitwise equality of a gathered state and a reference-layout one."""
    import jax
    g = jax.tree.leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    return all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(g, w))


def _as_dict(state):
    """A reference ``TrainState`` (or a port ``reference_tree``) as
    ``whole_tree``'s dict."""
    return dict(params=state.params, mu=state.opt.mu, nu=state.opt.nu,
                count=int(np.asarray(state.opt.count)),
                step=int(np.asarray(state.step)))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_reference_checkpoint_restores_on_a_mesh(ckpts, world):
    import jax
    want = _as_dict(jax.tree.map(np.asarray, ckpts["rstate"]))
    for r in ckpts["ranks"][world]:
        tree, extra = r["from_reference"]
        assert extra == {"data_step": 1}
        assert trees_equal(tree, want)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_one_device_checkpoint_restores_on_a_mesh(ckpts, world):
    want = _as_dict(reference_tree(ckpts["one"]))
    for r in ckpts["ranks"][world]:
        tree, extra = r["from_one_device"]
        assert extra == {"data_step": 3}
        assert trees_equal(tree, want)


@pytest.mark.parametrize("writer,reader", [(2, 4), (4, 2)],
                         ids=["1x2-to-2x2", "2x2-to-1x2"])
def test_mesh_checkpoint_restores_on_the_other_mesh(ckpts, writer, reader):
    wrote = ckpts["ranks"][writer][0]["wrote"]
    assert all(trees_equal(r["wrote"], wrote)
               for r in ckpts["ranks"][writer])
    for r in ckpts["ranks"][reader]:
        tree, extra = r["from_other_mesh"]
        assert extra == {"data_step": 2}
        assert trees_equal(tree, wrote)


@pytest.mark.parametrize("writer", [2, 4], ids=["1x2", "2x2"])
def test_mesh_checkpoint_restores_in_the_reference(ckpts, writer):
    import jax
    from repro.checkpoint import restore_pytree as ref_restore
    from repro.train import step as RS
    directory = ckpts["dirs"]["a" if writer == 2 else "b"]
    like = RS.train_state_specs(ckpts["rmodel"])
    state, extra = ref_restore(directory, 2, like)
    assert extra == {"data_step": 2}
    assert trees_equal(ckpts["ranks"][writer][0]["wrote"],
                       _as_dict(jax.tree.map(np.asarray, state)))


@pytest.mark.parametrize("writer", [2, 4], ids=["1x2", "2x2"])
def test_mesh_checkpoint_restores_on_one_device(ckpts, writer):
    directory = ckpts["dirs"]["a" if writer == 2 else "b"]
    _, state, _ = fresh(ckpts["cfg"])
    tree, extra = restore_pytree(directory, 2, reference_like(state))
    load_reference_tree(state, tree)
    assert extra == {"data_step": 2}
    assert trees_equal(_as_dict(reference_tree(state)),
                       ckpts["ranks"][writer][0]["wrote"])


def test_chunked_run_on_a_mesh_is_bitwise_the_unbroken_one(ckpts):
    assert all(r["chunked"] for r in ckpts["ranks"][2])


def test_launcher_trains_checkpoints_and_resumes_on_two_ranks(tmp_path):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu",
            "--model-parallel", "2", "--steps", "4", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2", "--log-every", "1"]
    runs = {}
    for name in ("a", "b"):
        if name == "b":
            shutil.copytree(tmp_path / "a" / "step_000000002",
                            tmp_path / "b" / "step_000000002")
        log = str(tmp_path / f"log-{name}")
        _join({name: mp.start_processes(
            _launch_rank, args=(_free_port(), argv + [
                "--ckpt-dir", str(tmp_path / name)], log),
            nprocs=2, join=False, start_method="spawn")}, "launch")
        runs[name] = [(open(f"{log}.{r}").read(),
                       torch.load(f"{log}.{r}.pt")) for r in range(2)]
    first, second = runs["a"][0][0], runs["b"][0][0]
    assert "mesh {'data': 1, 'model': 2} (tp)" in first
    assert "2 rank(s)" in first and "step     3 loss=" in first
    assert "resumed from step 2" in second and "step     1 " not in second
    assert runs["a"][1][0] == runs["b"][1][0] == ""      # rank 1 is quiet
    for a, b in zip(runs["a"], runs["b"]):
        assert a[1]["step"] == b[1]["step"] == 4
        assert all(torch.equal(a[1]["params"][n], b[1]["params"][n])
                   for n in a[1]["params"])
    x = np.load(tmp_path / "a" / "step_000000004" / "data.npz")
    y = np.load(tmp_path / "b" / "step_000000004" / "data.npz")
    assert sorted(x.files) == sorted(y.files)
    assert all(np.array_equal(x[k], y[k]) for k in x.files)
