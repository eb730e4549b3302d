"""Multi-device BP in the port (``repro_torch.dist``, ``ElasticMesh``),
held against the reference's one-device runs and the port's own.

Worlds of 2 and 4 gloo ranks run in spawned processes, started together by
one module fixture: each rank rendezvouses through a ``FileStore`` under
``tmp_path`` (no TCP port, so test workers never collide), with a process
group timeout, and runs every check of its world on the CPU, writing its
results to a file; a join deadline bounds each world. The tests then read
the results:

- twins of ``tests/test_system.py::TestDistributedBP`` (sharded LBP and
  RnBP, rlx and rlxtree with chunked resume, chunked resume bitwise, the
  bucket fold through ``run_many``, ``serve_async``) and of
  ``tests/test_perf_variants.py::TestBandedBP``, on the same graphs at the
  same eps, within 5e-3 of the reference's one-device beliefs (its own
  sharded and banded paths do not run on the installed jax);
- the rank-resident sharded path bitwise the port's one-device runs: a
  ``run`` and a chunked resume for each of the six frontier schedulers,
  ``run_many``'s slots and ``serve_async``'s records (rounds, messages,
  beliefs, updates, history); the chain fold bitwise ``vertex_logprod``;
  each rank's tensor bytes of graph and messages a fraction of one
  device's;
- banded LBP bitwise the port's one-device LBP, rounds and messages;
- every rank's messages bitwise equal;
- ``partition_banded`` bitwise the reference's arrays, and the error texts
  of both packages.
"""

import datetime
import time
import types

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
import torch.multiprocessing as mp

from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.core import serving as JS
from repro.dist import _check_edge_layout as j_check_layout
from repro.dist import bp_banded as JB
from repro.pgm import datasets as JD
from repro_torch import dist as D
from repro_torch.core import LBP, RBP, RS, BPConfig
from repro_torch.core.graph import PGM
from repro_torch.dist import bp_banded as TB
from repro_torch.ft import ElasticMesh
from repro_torch.pgm import datasets as TD

TOL = 5e-3                 # multi-device vs one-device beliefs (North star)
PG_TIMEOUT_S = 60          # a rank stuck in a collective fails this fast
JOIN_TIMEOUT_S = 420       # a world that outlives this is killed
CPU = "cpu"


# ------------------------------------------------------ inside each rank --

def _engine(scheduler, **kw):
    from repro_torch.core import BPEngine
    return BPEngine(BPConfig(scheduler=scheduler, **kw), device=CPU)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


#: the fields of a ``BPResult`` a sharded run must equal bitwise
SAME_FIELDS = ("rounds", "logm", "beliefs", "updates", "converged",
               "max_residual", "unconverged_history")


def _same(res, one):
    """{field: sharded ``res`` bitwise ``one`` in it} (zero signs too)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return {f: torch.equal(bits(getattr(res, f)), bits(getattr(one, f)))
            for f in SAME_FIELDS}


def _record(res, one=None):
    out = dict(rounds=int(res.rounds), converged=bool(res.converged),
               beliefs=res.beliefs, logm=res.logm)
    if one is not None:
        out.update(one_rounds=int(one.rounds), one_beliefs=one.beliefs,
                   one_logm=one.logm, same=_same(res, one))
    return out


#: the six frontier schedulers of the bitwise checks (frontiers widened so
#: the runs take tens of rounds, not hundreds)
BITWISE = (("lbp", {}), ("rbp", {"p": 1 / 16}), ("rs", {"p": 1 / 16}),
           ("rnbp", {}), ("rlx", {"p": 1 / 16}), ("rlxtree", {"p": 1 / 16}))
BITWISE_CHUNK = 11


def _checks_bitwise(mesh, out):
    """A sharded ``run`` and a chunked resume against the port's one-device
    run, for each frontier scheduler, with the same config and generator."""
    g = TD.ising_grid(8, 2.0, seed=0, device=CPU)
    for name, kw in BITWISE:
        cfg = dict(scheduler_kwargs=kw, eps=1e-4, max_rounds=2000)
        one = _engine(name, **cfg).run(g, _gen(5))
        eng = D.make_sharded_engine(name, mesh, device=CPU, **cfg)
        mono = eng.run(g, _gen(5))
        state = eng.init(g, _gen(5))
        while not eng.finished(state):
            state = eng.step(state, chunk_rounds=BITWISE_CHUNK)
        out[f"bitwise/{name}"] = dict(
            rounds=int(mono.rounds), one_rounds=int(one.rounds),
            slice_rows=int(state.logm.shape[0]), n_edges=g.n_edges,
            run=_same(mono, one), chunked=_same(eng.result(state), one))


def _padded(g, n):
    """``g`` re-padded so its edges split into even slices over ``n``."""
    from repro_torch.core.graph import pad_pgm
    need = -(-g.n_edges // (2 * n)) * (2 * n)
    return g if need == g.n_edges else pad_pgm(
        g, n_edges=need, n_vertices=g.n_vertices, n_states=g.n_states_max)


def _checks_resident(mesh, world, out):
    """The chain fold against ``vertex_logprod`` on irregular in-degrees
    (some messages -0.0), and what a rank holds of an S = 16 stereo graph
    and of a bucket of two, against one device."""
    from repro_torch.core import BatchedPGM
    from repro_torch.core import messages as M
    g = _padded(TD.protein_like_graph(60, seed=0, device=CPU), world)
    logm = torch.randn((g.n_edges, g.n_states_max), generator=_gen(1))
    logm[::7] = -0.0
    sp = D.shard_pgm(g, mesh)
    whole = M.vertex_logprod(g, logm)
    got = sp.vertex_sums(sp.local(logm))
    part = sp.vertex_sums(sp.local(logm), (5, 23))
    bits = lambda t: t.view(torch.int32)                    # noqa: E731
    out["fold"] = dict(
        bitwise=torch.equal(bits(got), bits(whole)),
        rows_bitwise=torch.equal(bits(part), bits(whole[5:23])),
        beliefs=torch.equal(sp.beliefs(sp.local(logm)), M.beliefs(g, logm)),
        gather=torch.equal(sp.gather(sp.local(logm)), logm))
    frames = [TD.stereo_mrf(24, 32, 16, seed=i, device=CPU).pgm
              for i in range(2)]
    cases = dict(graph=_padded(frames[0], world),
                 bucket=BatchedPGM.from_pgms(frames))
    for name, graph in cases.items():
        one = _engine("lbp").init(graph, _gen(0))
        state = D.make_sharded_engine("lbp", mesh, device=CPU).init(
            graph, _gen(0))
        u = state.graph.folded() if name == "bucket" else state.graph
        out[f"bytes/{name}"] = dict(
            rank=D.tensor_bytes(state.graph, state.logm),
            one=D.tensor_bytes(one.graph, one.logm),
            rows=dict(logm=state.logm.shape[0],
                      log_psi_e=u.log_psi_e.shape[0],
                      dst_mask=u.dst_mask.shape[0],
                      edge_rev=u.edge_rev.shape[0]),
            n_edges=u.n_edges)


def _checks_sharded(mesh, world, out):
    """Twins of TestDistributedBP's sharded parity and relaxed tests (the
    relaxed runs' chunked resume in the world of 2: a relaxed round is
    mostly its bisection, which every rank runs whole)."""
    from repro_torch.core import RnBP
    g = TD.ising_grid(16, 2.5, seed=0, device=CPU)
    for name, sched in (("lbp", LBP()), ("rnbp", RnBP(low_p=0.7))):
        res = D.run_bp_sharded(g, sched, mesh, _gen(0), eps=1e-6,
                               max_rounds=4000, device=CPU)
        one = _engine(sched, eps=1e-6, max_rounds=4000).run(g, _gen(0))
        out[f"sharded/{name}"] = _record(res, one)
    spgm = D.shard_pgm(g, mesh)
    for name in ("rlx", "rlxtree"):
        eng = D.make_sharded_engine(name, mesh, eps=1e-6, max_rounds=20000,
                                    device=CPU)
        mono = eng.run(spgm, _gen(7))
        out[f"sharded/{name}"] = _record(mono)
        if world != 2:
            continue
        state = eng.init(spgm, _gen(7))
        while not eng.finished(state):
            state = eng.step(state, chunk_rounds=37)
        chunked = eng.result(state)
        out[f"sharded/{name}"].update(
            chunked_rounds=int(chunked.rounds),
            chunked_bitwise=torch.equal(mono.logm, chunked.logm))


def _checks_resume(mesh, out):
    """Twin of test_sharded_chunked_resume_bitwise."""
    g = TD.ising_grid(12, 2.5, seed=0, device=CPU)
    eng = D.make_sharded_engine("rnbp", mesh, eps=1e-4, max_rounds=1200,
                                device=CPU)
    spgm = D.shard_pgm(g, mesh)
    mono = eng.run(spgm, _gen(7))
    state = eng.init(spgm, _gen(7))
    while not eng.finished(state):
        state = eng.step(state, chunk_rounds=23)
    chunked = eng.result(state)
    out["resume"] = dict(
        _record(mono), chunked_rounds=int(chunked.rounds),
        chunked_converged=bool(chunked.converged),
        bitwise=torch.equal(mono.logm, chunked.logm)
        and torch.equal(mono.beliefs, chunked.beliefs))


def _checks_resilient(mesh, ckpt_dir, out):
    """``run_bp_resilient`` on the sharded backend: checkpoints hold the
    whole messages, and a run resumed from a mid-run checkpoint (this
    rank's directory) ends bitwise where the one-device run does."""
    import os
    import shutil
    from repro_torch.ft import run_bp_resilient
    g = TD.ising_grid(8, 2.0, seed=0, device=CPU)
    kw = dict(eps=1e-4, max_rounds=400, rounds_per_chunk=5, device=CPU,
              ckpt_dir=ckpt_dir, backend=D.make_sharded_update(mesh))
    one = _engine("rnbp", eps=1e-4, max_rounds=400).run(g, _gen(9))
    full = run_bp_resilient(g, "rnbp", _gen(9), **kw)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir))
    mid = steps[len(steps) // 2]
    for step in steps:
        if step > mid:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{step:09d}"))
    resumed = run_bp_resilient(g, "rnbp", _gen(99), **kw)
    out["resilient"] = dict(
        mid=mid, rounds=int(one.rounds), resumed_rounds=int(resumed.rounds),
        full=all(_same(full, one).values()),
        resumed=torch.equal(resumed.logm, one.logm)
        and torch.equal(resumed.beliefs, one.beliefs))


def _checks_buckets(mesh, out):
    """Twins of the bucket-fold and async-serving tests; the registry
    path; the calls that timing-driven serving makes, which the sharded
    backend once refused."""
    from repro_torch.core import serve_async
    from repro_torch.serve import Router
    pgms = [TD.ising_grid(10 + (i % 3), 2.0, seed=i, device=CPU)
            for i in range(6)]
    sharded = D.make_sharded_engine("rnbp", mesh, eps=1e-4, max_rounds=1500,
                                    device=CPU)
    res = sharded.run_many(pgms, 3)
    one = _engine("rnbp", eps=1e-4, max_rounds=1500).run_many(pgms, 3)
    out["run_many"] = [_record(r, o) for r, o in zip(res, one)]

    fast = [TD.ising_grid(8, 1.5, seed=s, device=CPU) for s in range(5)]
    stream = fast[:2] + [TD.ising_grid(8, 3.5, seed=0, device=CPU)] \
        + fast[2:]
    kw = dict(max_batch=3, chunk_rounds=48, compact=True, slots=2)
    sharded = D.make_sharded_engine("lbp", mesh, eps=1e-5, max_rounds=192,
                                    device=CPU)
    rep = serve_async(sharded, stream, 0, **kw)
    rep1 = serve_async(_engine("lbp", eps=1e-5, max_rounds=192), stream, 0,
                       **kw)
    out["serve"] = dict(
        compactions=rep.stats.compactions, evacuated=rep.stats.evacuated,
        n=len(stream), results=[_record(r, o) for r, o in
                                zip(rep.results, rep1.results)])
    # one resident bucket of three: backfills into slots whose rows
    # straddle ranks, then a compaction
    kw = dict(max_batch=3, chunk_rounds=16, compact=True, slots=1)
    rep = serve_async(sharded, stream, 0, **kw)
    rep1 = serve_async(_engine("lbp", eps=1e-5, max_rounds=192), stream, 0,
                       **kw)
    out["serve_backfill"] = dict(
        compactions=rep.stats.compactions, backfilled=rep.stats.backfilled,
        same=[_same(r, o) for r, o in zip(rep.results, rep1.results)])

    timed = {}
    for name, kwargs in (("windowed", dict(admission="windowed")),
                         ("deadline", dict(admission="deadline")),
                         ("ingest", dict(ingest_threads=1))):
        rep = serve_async(sharded, stream, 0, **kwargs)
        timed[name] = [(r.rid, all(_same(r.result, rep1.results[r.rid])
                                   .values())) for r in rep.records]
    online = serve_async(_engine("lbp", eps=1e-5, max_rounds=192),
                         iter(stream), 0)
    with Router([sharded], 0) as router:
        timed["router"] = [(r.rid, all(_same(
            r.result, online.results[r.rid]).values()))
            for r in router.serve(iter(stream))]
    out["timed"] = timed

    g = TD.ising_grid(8, 1.5, seed=0, device=CPU)
    from repro_torch.core import BPEngine
    eng = BPEngine(BPConfig(scheduler="lbp", eps=1e-5, backend="sharded"),
                   device=CPU)
    out["registry"] = dict(
        _record(eng.run(g, _gen(0)), _engine("lbp", eps=1e-5).run(
            g, _gen(0))),
        axis=eng.update_fn.axis, mesh_size=eng.update_fn.mesh.size(),
        to_dict=BPConfig(scheduler="lbp", eps=1e-5,
                         backend="sharded").to_dict())
    try:
        logm = torch.zeros((6, g.n_states_max))
        eng.update_fn(g, logm)
    except ValueError as e:
        out["odd_axis"] = str(e)


def _checks_banded(mesh, world, out):
    """Twins of TestBandedBP's parity and relaxed tests, at n = world."""
    from repro_torch.core import RLX, RLXTree, RnBP
    for name, g in (("grid24", TD.ising_grid_fast(24, 2.5, seed=0,
                                                  device=CPU)),
                    ("chain2000", TD.chain_graph(2000, seed=0, device=CPU))):
        one = _engine("lbp", eps=1e-5, max_rounds=6000).run(g, _gen(0))
        logm, rounds, done = D.run_bp_banded(D.partition_banded(g, world),
                                             LBP(), mesh, 0, eps=1e-5,
                                             max_rounds=6000)
        out[f"banded/{name}"] = dict(
            rounds=int(rounds), done=bool(done), logm=logm,
            one_rounds=int(one.rounds), one_logm=one.logm)
    g = TD.ising_grid_fast(24, 2.5, seed=0, device=CPU)
    part = D.partition_banded(g, world)
    for sched in (RLX(), RLXTree(), RnBP()):
        logm, rounds, done = D.run_bp_banded(part, sched, mesh, 0, eps=1e-4,
                                             max_rounds=10000)
        from repro_torch.core import messages as M
        out[f"banded/{type(sched).__name__.lower()}"] = dict(
            rounds=int(rounds), done=bool(done), logm=logm,
            beliefs=M.beliefs(g, logm))


def _rank_main(rank, world, out_dir, part):
    """One rank of a world: the ``"sharded"`` or the ``"banded"`` checks,
    then the mesh and transport checks."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = D.make_bp_mesh(device=CPU)
        t0 = time.perf_counter()
        out = dict(transport=D.comm.transport(mesh.get_group("bp"), CPU))
        if part == "sharded":
            _checks_sharded(mesh, world, out)
            _checks_resume(mesh, out)
            _checks_buckets(mesh, out)
            _checks_bitwise(mesh, out)
            _checks_resident(mesh, world, out)
            _checks_resilient(mesh, f"{out_dir}/ckpt{rank}", out)
        else:
            _checks_banded(mesh, world, out)
        em = ElasticMesh(model_parallel=4 if world == 2 else 3, device=CPU)
        m2 = em.current()
        out["elastic"] = dict(size=m2.size(), shape=tuple(m2.mesh.shape),
                              changed=em.changed())
        try:
            D.comm.all_reduce_count(torch.zeros(()), mesh.get_group("bp"))
        except TypeError as e:
            out["float_reduce"] = str(e)
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


#: the worlds the fixture runs at once: (ranks, which checks)
WORLDS = ((2, "sharded"), (2, "banded"), (4, "sharded"), (4, "banded"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [rank 0's results, rank 1's, ...]}: every world of
    ``WORLDS`` runs at once, and a world size's results merge its
    worlds'."""
    dirs = {job: tmp_path_factory.mktemp(f"world{job[0]}-{job[1]}")
            for job in WORLDS}
    running = {job: mp.start_processes(
        _rank_main, args=(job[0], str(d), job[1]), nprocs=job[0],
        join=False, start_method="spawn") for job, d in dirs.items()}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while running:
        for job, ctx in list(running.items()):
            if ctx.join(timeout=0.5):
                del running[job]
        if running and time.monotonic() > deadline:
            for ctx in running.values():
                for p in ctx.processes:
                    p.kill()
            raise TimeoutError(f"worlds {sorted(running)} did not finish "
                               f"in {JOIN_TIMEOUT_S} s")
    out = {}
    for (w, _), d in dirs.items():
        ranks = out.setdefault(w, [{} for _ in range(w)])
        for r in range(w):
            ranks[r].update(torch.load(d / f"rank{r}.pt"))
    return out


# ------------------------------------------------------- the reference --

def j_lbp_beliefs(jpgm, eps, max_rounds):
    res = JEngine(JConfig(scheduler="lbp", eps=eps,
                          max_rounds=max_rounds)).run(jpgm, jax.random.key(0))
    assert bool(res.converged)
    return np.asarray(res.beliefs)


def close(port, ref, mask=None, tol=TOL):
    d = np.abs(np.asarray(port) - np.asarray(ref))
    if mask is not None:
        d = np.where(np.asarray(mask), d, 0.0)
    return float(d.max()) < tol


# ------------------------------------------------------------ the tests --

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["lbp", "rnbp"])
def test_sharded_bp_matches_single_device(worlds, world, name):
    jg = JD.ising_grid(16, 2.5, seed=0)
    ref = j_lbp_beliefs(jg, 1e-6, 4000)
    r = worlds[world][0][f"sharded/{name}"]
    assert r["converged"]
    assert close(r["beliefs"], ref, jg.state_mask)
    assert close(r["beliefs"], r["one_beliefs"], jg.state_mask)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["rlx", "rlxtree"])
def test_sharded_relaxed_scheduler_converges(worlds, world, name):
    jg = JD.ising_grid(16, 2.5, seed=0)
    ref = j_lbp_beliefs(jg, 1e-6, 4000)
    r = worlds[world][0][f"sharded/{name}"]
    assert r["converged"], name
    assert close(r["beliefs"], ref, jg.state_mask)
    if world == 2:
        assert r["chunked_rounds"] == r["rounds"] and r["chunked_bitwise"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_chunked_resume_bitwise(worlds, world):
    r = worlds[world][0]["resume"]
    assert r["converged"] and r["chunked_converged"]
    assert r["rounds"] == r["chunked_rounds"] and r["bitwise"]


@pytest.mark.parametrize("world", [2, 4])
def test_batched_bucket_through_sharded_fold(worlds, world):
    jpgms = [JD.ising_grid(10 + (i % 3), 2.0, seed=i) for i in range(6)]
    ref = JEngine(JConfig(scheduler="rnbp", eps=1e-4, max_rounds=1500)) \
        .run_many(jpgms, jax.random.key(3))
    for r, j in zip(worlds[world][0]["run_many"], ref):
        assert r["converged"] and bool(j.converged)
        assert close(r["beliefs"], j.beliefs)
        assert close(r["beliefs"], r["one_beliefs"])


@pytest.mark.parametrize("world", [2, 4])
def test_async_serving_through_sharded_backend(worlds, world):
    fast = [JD.ising_grid(8, 1.5, seed=s) for s in range(5)]
    stream = fast[:2] + [JD.ising_grid(8, 3.5, seed=0)] + fast[2:]
    kw = dict(max_batch=3, chunk_rounds=48, compact=True, slots=2)
    ref = JS.serve_async(JEngine(JConfig(scheduler="lbp", eps=1e-5,
                                         max_rounds=192)),
                         stream, jax.random.key(0), **kw)
    s = worlds[world][0]["serve"]
    assert s["compactions"] >= 1 and s["evacuated"] == s["n"]
    for r, j in zip(s["results"], ref.results):
        assert r["rounds"] == r["one_rounds"]
        assert close(r["beliefs"], j.beliefs)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_backend_refuses_timing_driven_serving(worlds, world):
    """The four calls the sharded backend once refused -- ``windowed`` and
    ``deadline`` admission on the wall clock, an ingest thread, and the
    router over one sharded engine -- now serve on every rank: every rid
    once, each bitwise the port's one-device result (the router's against
    the online ``serve_async``, whose padding it shares)."""
    for r in worlds[world]:
        timed = r["timed"]
        assert sorted(timed) == ["deadline", "ingest", "router", "windowed"]
        for name, got in timed.items():
            assert sorted(rid for rid, _ in got) == list(range(6)), name
            assert all(ok for _, ok in got), name


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_registry_name_resolves_inside_a_world(worlds, world):
    r = worlds[world][0]["registry"]
    assert r["mesh_size"] == world and r["axis"] == "bp"
    assert r["converged"] and r["rounds"] == r["one_rounds"]
    assert close(r["beliefs"], r["one_beliefs"])
    assert r["to_dict"] == JConfig(scheduler="lbp", eps=1e-5,
                                   backend="sharded").to_dict()
    assert f"does not split into even shards over {world} devices" in \
        worlds[world][0]["odd_axis"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [name for name, _ in BITWISE])
def test_sharded_run_is_bitwise_one_device(worlds, world, name):
    """Every rank keeps only its slice, and the run is the port's
    one-device run bit for bit: rounds, messages, beliefs, updates,
    history."""
    r = worlds[world][0][f"bitwise/{name}"]
    assert r["slice_rows"] * world == r["n_edges"]
    assert r["rounds"] == r["one_rounds"] > 1
    assert all(r["run"].values()), r["run"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [name for name, _ in BITWISE])
def test_sharded_chunked_resume_is_bitwise_one_device(worlds, world, name):
    r = worlds[world][0][f"bitwise/{name}"]
    assert r["rounds"] > BITWISE_CHUNK
    assert all(r["chunked"].values()), r["chunked"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["lbp", "rnbp"])
def test_sharded_paper_grid_is_bitwise_one_device(worlds, world, name):
    """The 16 x 16 grid at eps = 1e-6 of the reference's twin test."""
    r = worlds[world][0][f"sharded/{name}"]
    assert all(r["same"].values()), r["same"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_run_many_slots_are_bitwise_one_device(worlds, world):
    for r in worlds[world][0]["run_many"]:
        assert all(r["same"].values()), r["same"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_serve_async_records_are_bitwise_one_device(worlds, world):
    """Through admission, evacuation, backfill into a slot whose rows may
    straddle ranks, and a compaction that splits the narrower union
    anew."""
    s = worlds[world][0]["serve"]
    for r in s["results"]:
        assert all(r["same"].values()), r["same"]
    s = worlds[world][0]["serve_backfill"]
    assert s["compactions"] >= 1 and s["backfilled"] >= 1
    for same in s["same"]:
        assert all(same.values()), same


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_resilient_run_resumes_bitwise(worlds, world):
    r = worlds[world][0]["resilient"]
    assert r["full"] and r["resumed"] and 0 < r["mid"] < r["rounds"]
    assert r["resumed_rounds"] == r["rounds"] - r["mid"]


@pytest.mark.parametrize("world", [2, 4])
def test_chain_fold_is_vertex_logprod_bitwise(worlds, world):
    f = worlds[world][0]["fold"]
    assert f["bitwise"] and f["rows_bitwise"]
    assert f["beliefs"] and f["gather"]


#: a rank's bytes of graph and messages over one device's, at most
SHARE = {2: 0.6, 4: 0.35}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["graph", "bucket"])
def test_rank_holds_its_slice_of_graph_and_messages(worlds, world, case):
    """An S = 16 stereo graph (and a bucket of two): messages, pairwise
    tables, destination masks and reverse indices are the rank's E/n rows,
    and a rank's tensor bytes are ~1/n of one device's."""
    for r in worlds[world]:
        b = r[f"bytes/{case}"]
        assert set(b["rows"].values()) == {b["n_edges"] // world}
        assert b["rank"] <= SHARE[world] * b["one"], b


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["grid24", "chain2000"])
def test_banded_matches_reference(worlds, world, name):
    """Banded LBP is round-exact against the reference and bitwise the
    port's one-device run, messages included."""
    jg = (JD.ising_grid_fast(24, 2.5, seed=0) if name == "grid24"
          else JD.chain_graph(2000, seed=0))
    ref = JEngine(JConfig(scheduler="lbp", eps=1e-5, max_rounds=6000)).run(
        jg, jax.random.key(0))
    r = worlds[world][0][f"banded/{name}"]
    assert r["done"]
    assert r["rounds"] == r["one_rounds"] == int(ref.rounds)
    assert torch.equal(r["logm"], r["one_logm"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["rlx", "rlxtree", "rnbp"])
def test_banded_relaxed_converges(worlds, world, name):
    jg = JD.ising_grid_fast(24, 2.5, seed=0)
    ref = j_lbp_beliefs(jg, 1e-5, 6000)
    r = worlds[world][0][f"banded/{name}"]
    assert r["done"], f"banded {name} did not converge"
    assert close(r["beliefs"], ref, jg.state_mask)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_messages(worlds, world):
    ranks = worlds[world]
    keys = [k for k, v in ranks[0].items() if isinstance(v, dict)
            and "logm" in v]
    keys += [("run_many", i) for i in range(len(ranks[0].get("run_many",
                                                              ())))]
    assert len(keys) >= 5
    for other in ranks[1:]:
        for k in keys:
            a = ranks[0][k[0]][k[1]] if isinstance(k, tuple) else ranks[0][k]
            b = other[k[0]][k[1]] if isinstance(k, tuple) else other[k]
            assert torch.equal(a["logm"], b["logm"]), k
            assert a["rounds"] == b["rounds"], k


@pytest.mark.parametrize("world", [2, 4])
def test_elastic_mesh_spans_the_world(worlds, world):
    """Twin of test_elastic_mesh_single_device: the model axis shrinks to a
    divisor of the world (4 -> 2 ranks of 2; 3 -> 2 of 4)."""
    e = worlds[world][0]["elastic"]
    assert e["size"] == world and not e["changed"]
    assert e["shape"] == ((1, 2) if world == 2 else (2, 2))


def test_elastic_mesh_single_device(tmp_path):
    """``ElasticMesh`` in a world of one, in this process."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        em = ElasticMesh(model_parallel=4, device=CPU)
        mesh = em.current()
        assert mesh.size() == 1 and not em.changed()
        assert D.make_bp_mesh(device=CPU).size() == 1
    finally:
        dist.destroy_process_group()
    assert em.changed()


def test_worlds_use_gloo_and_refuse_float_reductions(worlds):
    for w, ranks in worlds.items():
        for r in ranks:
            assert r["transport"] == "gloo"
            assert "integers only" in r["float_reduce"]


# ---------------------------------------------- no world: host and errors --

def bridge(jpgm):
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device=CPU)


@pytest.mark.parametrize("make,n", [
    (lambda m: m.ising_grid_fast(24, 2.5, seed=0), 8),
    (lambda m: m.ising_grid_fast(24, 2.5, seed=0), 1),
    (lambda m: m.chain_graph(2000, seed=0), 8),
    (lambda m: m.chain_graph(301, seed=1), 3),
    (lambda m: m.ising_grid(7, 2.0, seed=2), 2),
    (lambda m: m.stereo_mrf(6, 8, 3, seed=0).pgm, 4),
], ids=["grid24-8", "grid24-1", "chain2000-8", "chain301-3", "grid7-2",
        "stereo-4"])
def test_partition_banded_is_the_reference_bitwise(make, n):
    jpgm = make(JD)
    jp = JB.partition_banded(jpgm, n)
    tp = D.partition_banded(bridge(jpgm), n)
    assert (tp.n, tp.band_len) == (jp.n, jp.band_len)
    for f in ("v_lo", "edge_src", "edge_dst", "edge_rev", "edge_mask",
              "log_psi_e", "slot_edge"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_partition_rejects_unbanded():
    jpgm = JD.protein_like_graph(60, seed=0)
    with pytest.raises(AssertionError):
        JB.partition_banded(jpgm, 32)
    with pytest.raises(AssertionError):
        D.partition_banded(TD.protein_like_graph(60, seed=0, device=CPU), 32)


def test_banded_unsupported_scheduler_error_lists_rlx():
    part = D.partition_banded(TD.ising_grid_fast(6, 1.0, seed=0, device=CPU),
                              1)
    for sched in (RBP(), RS(), "rbp"):
        with pytest.raises(NotImplementedError) as ei:
            D.run_bp_banded(part, sched, None, 0)
        msg = str(ei.value)
        assert "unknown banded scheduler" in msg
        assert "'rlx'" in msg and "'rlxtree'" in msg
        assert "'lbp'" in msg and "'rnbp'" in msg
    with pytest.raises(NotImplementedError, match="inner_sweeps=2"):
        D.run_bp_banded(part, LBP(inner_sweeps=2), None, 0)
    assert sorted(TB.BANDED_SCHEDULERS) == sorted(JB.BANDED_SCHEDULERS)


def _layout_cases():
    e = 128
    crossing = np.arange(e, dtype=np.int32)
    crossing[[0, 64]] = [64, 0]
    return [(np.arange(e, dtype=np.int32), 3),       # not divisible
            (np.arange(e, dtype=np.int32), 128),     # odd shard size
            (crossing, 2)]                           # pair split


@pytest.mark.parametrize("case", range(3))
def test_layout_errors_are_the_reference_texts(case):
    rev, n = _layout_cases()[case]
    with pytest.raises(ValueError) as ej:
        j_check_layout(types.SimpleNamespace(n_edges=rev.size,
                                             edge_rev=rev), n)
    with pytest.raises(ValueError) as et:
        D._check_edge_layout(types.SimpleNamespace(
            n_edges=rev.size, edge_rev=torch.from_numpy(rev)), n)
    assert str(et.value) == str(ej.value)


def test_folded_bucket_checks_the_mesh_split():
    """A bucket's union must split evenly over the mesh: 3 ranks cannot
    share B*E = 256 edges."""
    from repro_torch.core import BatchedPGM
    batch = BatchedPGM.from_pgms([TD.ising_grid(3, 2.0, seed=i, device=CPU)
                                  for i in range(2)])
    mesh = types.SimpleNamespace(
        mesh_dim_names=("bp",), size=lambda dim=0: 3,
        get_local_rank=lambda axis: 0, get_group=lambda axis: None)
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        batch.folded(mesh)
    plan_mesh = types.SimpleNamespace(
        mesh_dim_names=("bp",), size=lambda dim=0: 2,
        get_local_rank=lambda axis: 1, get_group=lambda axis: None)
    union = batch.folded(plan_mesh)
    assert union is batch.folded(plan_mesh)
    whole = batch.folded()
    plan = union.plan
    assert (plan.lo, plan.hi) == union.span == (128, 256)
    assert torch.equal(union.log_psi_e, whole.log_psi_e[128:])
    assert torch.equal(union.edge_rev + 128, whole.edge_rev[128:])
    assert torch.equal(union.edge_src, whole.edge_src)
    ids = plan.in_edges[plan.in_mask]
    assert int(ids.min()) >= 0 and int(ids.max()) < 128
    assert bool((whole.edge_dst[ids.long() + 128] ==
                 plan.rows[:, None].expand_as(plan.in_mask)[
                     plan.in_mask]).all())


def test_make_bp_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        D.make_bp_mesh(device=CPU)
    with pytest.raises(RuntimeError, match="init_process_group"):
        from repro_torch.core import BPEngine
        BPEngine(BPConfig(backend="sharded"), device=CPU)
    with pytest.raises(RuntimeError, match="init_process_group"):
        ElasticMesh(device=CPU).current()


def test_rank_order_sum_adds_left_to_right():
    """The cross-rank vertex sum is a chain: rank 0 folds its in-edges,
    rank 1 continues from its table, ... -- the one-device fold's order. A
    vertex whose in-edges 1e8, 1, -1e8 split as [1e8] | [1, -1e8] sums to
    (1e8 + 1) - 1e8 = 0 in float32 as one device does; the order 1e8,
    -1e8, 1 would give 1."""
    from repro_torch.core import messages as M
    vals = torch.tensor([[1e8], [1.0], [-1e8]])
    one = M.fold_in_edges(torch.tensor([[0, 1, 2]]),
                          torch.ones((1, 3), dtype=torch.bool), vals)
    true = torch.ones((1, 1), dtype=torch.bool)
    acc = M.fold_in_edges_from(torch.zeros((1, 1)), torch.tensor([[0]]),
                               true, true, vals[:1])           # rank 0
    acc = M.fold_in_edges_from(acc, torch.tensor([[0, 1]]),
                               torch.ones((1, 2), dtype=torch.bool),
                               torch.zeros((1, 2), dtype=torch.bool),
                               vals[1:])                        # rank 1
    assert float(one) == float(acc) == 0.0
    other = M.fold_in_edges(torch.tensor([[0, 2, 1]]),
                            torch.ones((1, 3), dtype=torch.bool), vals)
    assert float(other) == 1.0
    # a vertex whose first in-edge sits on a later rank starts from it
    neg = torch.tensor([[-0.0]])
    started = M.fold_in_edges_from(torch.zeros((1, 1)), torch.tensor([[0]]),
                                   true, true, neg)
    assert torch.equal(started.view(torch.int32), neg.view(torch.int32))


def _fake_mesh(n, rank):
    return types.SimpleNamespace(
        mesh_dim_names=("bp",), size=lambda dim=0: n,
        get_local_rank=lambda axis: rank, get_group=lambda axis: None)


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_slice_of_a_stereo_graph(n):
    """Placement alone (no world): the ranks' slices tile the pairwise
    tables and reverse indices exactly, each rank's plan names exactly its
    real edges, and a rank holds ~1/n of one device's bytes."""
    from repro_torch.core import messages as M
    g = _padded(TD.stereo_mrf(24, 32, 16, seed=0, device=CPU).pgm, n)
    one = D.tensor_bytes(g, M.init_messages(g))
    parts = [D.shard_pgm(g, _fake_mesh(n, r)) for r in range(n)]
    assert torch.equal(torch.cat([p.log_psi_e for p in parts]), g.log_psi_e)
    assert torch.equal(torch.cat([p.edge_rev + p.span[0] for p in parts]),
                       g.edge_rev)
    assert torch.equal(torch.cat([p.init_messages() for p in parts]),
                       M.init_messages(g))
    assert sum(int(p.plan.in_mask.sum()) for p in parts) == \
        int(g.edge_mask.sum())
    for p in parts:
        assert D.tensor_bytes(p, p.init_messages()) <= SHARE[n] * one


def test_rank_resident_graph_needs_the_sharded_backend():
    from repro_torch.core import BPEngine
    g = TD.ising_grid(3, 2.0, seed=0, device=CPU)
    sp = D.shard_pgm(g, _fake_mesh(2, 0))
    with pytest.raises(ValueError, match="rank-resident"):
        BPEngine(BPConfig(), device=CPU).run(sp, _gen(0))
    update = D.make_sharded_update(_fake_mesh(2, 0))
    with pytest.raises(ValueError, match="batch_backend must be None"):
        BPEngine(BPConfig(backend=update, batch_backend="triton"),
                 device=CPU)
    with pytest.raises(ValueError, match="rank-resident graph"):
        update(g, torch.zeros((g.n_edges, g.n_states_max)))
    with pytest.raises(ValueError, match="rank 1 of 2's slice"):
        D.shard_pgm(D.shard_pgm(g, _fake_mesh(2, 1)), _fake_mesh(2, 0))


def kind_bytes(nonzero):
    """``comm.STATS``'s ``"bytes/<kind>"`` entries: ``nonzero`` and 0."""
    return {f"bytes/{k}": nonzero.get(k, 0) for k in D.comm.KINDS}


def test_host_staging_round_trips_through_the_host(tmp_path, monkeypatch):
    """The staging helper (taken for CUDA tensors on a gloo group) rehearsed
    on CPU tensors in a world of one: every collective's outputs come back
    through host buffers, and the staged bytes are counted."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        group = D.mesh_axis(D.make_bp_mesh(device=CPU))[2]
        assert D.comm.transport(group, CPU) == "gloo"
        assert D.comm.transport(group, "cuda") == "gloo, host-staged"
        monkeypatch.setattr(D.comm, "transport",
                            lambda g, d: "gloo, host-staged")
        D.comm.reset_stats()
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(D.comm.all_gather(x, group)[0], x)
        out = torch.empty_like(x)
        D.comm.all_gather_into(out, x, group)
        assert torch.equal(out, x)
        c = torch.tensor(5)
        assert int(D.comm.all_reduce_count(c, group)) == 5
        # the collectives' result bytes: two gathers of 24 B, and an
        # all-reduce of 8 B at twice its result
        assert D.comm.STATS == {"collectives": 3,
                                "staged_bytes": 4 * 24 + 2 * 8,
                                "decisions": 0, "decision_bytes": 0,
                                "decision_ms": 0.0, **kind_bytes(
                                    {"all-gather": 48, "all-reduce": 16})}
        assert D.comm.GROUP_BYTES == {(0,): 64}
    finally:
        dist.destroy_process_group()


def test_chain_pass_and_broadcast_in_a_world_of_one(tmp_path, monkeypatch):
    """``send_next``/``recv_prev`` have no peer in a world of one; the
    ``broadcast`` from rank 0 stages its tensor out through the host once,
    and is counted."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        group = D.mesh_axis(D.make_bp_mesh(device=CPU))[2]
        monkeypatch.setattr(D.comm, "transport",
                            lambda g, d: "gloo, host-staged")
        D.comm.reset_stats()
        x = torch.arange(6.0).reshape(3, 2)
        D.comm.send_next(x, group)
        buf = torch.full((3, 2), 7.0)
        assert D.comm.recv_prev(buf, group) is buf
        assert torch.equal(buf, torch.full((3, 2), 7.0))
        assert D.comm.broadcast(x, 0, group) is x
        assert torch.equal(x, torch.arange(6.0).reshape(3, 2))
        assert D.comm.STATS == {"collectives": 1, "staged_bytes": 24,
                                "decisions": 0, "decision_bytes": 0,
                                "decision_ms": 0.0, **kind_bytes(
                                    {"collective-broadcast": 24})}
    finally:
        dist.destroy_process_group()
