"""Serving over sub-meshes under ``"sharded"``: wall-clock serving
decisions taken once per group, and a router whose replicas each span a
group of ranks (``repro_torch.core.serving``, ``repro_torch.serve``,
``repro_torch.dist.make_bp_mesh(ranks=...)``, ``dist.comm.publish`` and
``Channel``).

One world of 4 gloo ranks runs in spawned processes, started by one module
fixture (a ``FileStore`` under ``tmp_path``, a process-group timeout, a
join deadline). Every rank builds the whole mesh and the two sub-meshes
(ranks 0, 1 and 2, 3), then runs every case below, writing its records to
a file; the tests read them:

- ``serve_async`` under ``windowed`` and ``deadline`` admission on the wall
  clock with two ingest threads, on the whole mesh and on both sub-meshes
  at once, with one rank's stream sleeping before each item (a follower's
  in one run, the leader's in another): every rank of a group yields the
  same records, each non-evicted record is bitwise the port's one-device
  ``serve_async`` for its rid, within 5e-3 of the reference's
  ``serve_async`` with LBP's rounds equal;
- ``serve_routed`` over the two sub-meshes: round robin without stealing
  (each share bitwise its solo sharded ``serve_async``), ``least_loaded``
  with stealing on a skewed stream (steals > 0), ``kind_affinity``, and
  ``deadline`` routing with SLOs: every non-evicted result bitwise the
  one-device result for its rid and within 5e-3 of the reference's
  ``serve_routed`` over one-device engines, every rid released once, the
  front's ``RouterStats.routed`` summing to the stream's length;
- a sub-mesh on its non-member ranks: no coordinate, an engine that builds
  and refuses to run.
"""

import datetime
import time

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
import torch.multiprocessing as mp

from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.core import serving as JS
from repro.pgm import datasets as JD
from repro.serve import serve_routed as j_serve_routed
from repro_torch import dist as D
from repro_torch.core import BPConfig, BPEngine, serve_async
from repro_torch.core.graph import PGM
from repro_torch.pgm import datasets as TD

TOL = 5e-3                 # multi-device vs one-device beliefs (North star)
WORLD = 4
SUBMESHES = ((0, 1), (2, 3))
PG_TIMEOUT_S = 60          # a rank stuck in a collective fails this fast
JOIN_TIMEOUT_S = 240       # a world that outlives this is killed
SLEEP_S = 0.01             # the skewed rank's pause before each item
CPU = "cpu"
CFG = dict(scheduler="lbp", eps=1e-4, max_rounds=200, history=False)
KW = dict(max_batch=2, slots=2, prefetch=4, chunk_rounds=8)
WINDOWED = dict(admission="windowed", admission_kwargs={"window_s": 0.02},
                ingest_threads=2)
DEADLINE = dict(admission="deadline", ingest_threads=2)
#: rid -> latency budget (s) of the deadline runs; rid 5 cannot make it
SLOS = {0: 30.0, 2: 30.0, 5: 0.0, 7: 30.0}


def graphs(M, **dev):
    """The stream: small Ising, chain and loop graphs and two 8 x 8 stereo
    frames, built by datasets module ``M`` (either package's)."""
    return [M.ising_grid(6, 1.5, seed=0, **dev),
            M.chain_graph(30, seed=1, **dev),
            M.loop_graph(12, seed=2, **dev),
            M.stereo_mrf(8, 8, 4, seed=0, **dev).pgm,
            M.ising_grid(6, 2.0, seed=3, **dev),
            M.chain_graph(34, seed=4, **dev),
            M.stereo_mrf(8, 8, 4, seed=1, **dev).pgm,
            M.loop_graph(16, seed=5, **dev),
            M.ising_grid(6, 1.8, seed=6, **dev),
            M.chain_graph(30, seed=7, **dev)]


def items(pgms, slos=None, sleep=False):
    """``(rid, pgm, slo)`` per graph, pausing ``SLEEP_S`` before each when
    ``sleep``."""
    for rid, pgm in enumerate(pgms):
        if sleep:
            time.sleep(SLEEP_S)
        yield rid, pgm, (slos or {}).get(rid)


def skewed(M, **dev):
    """A straggler (6 x 6 Ising at C = 3.5, which LBP does not finish in
    ``SKEW_CFG``'s 400 rounds) and 15 fast grids: the straggler pins its
    replica's only slot while the other replica drains its share."""
    return [M.ising_grid(6, 3.5, seed=100, **dev)] + [
        M.ising_grid(6, 1.5, seed=s, **dev) for s in range(15)]


SKEW_CFG = dict(CFG, max_rounds=400)
SKEW_KW = dict(max_batch=1, slots=1, prefetch=1, chunk_rounds=8,
               ingest_queue=1, steal_batch=2, low_watermark=1)


# ------------------------------------------------------ inside each rank --

def _records(recs):
    return [dict(rid=r.rid, status=r.status, rounds=int(r.result.rounds),
                 logm=r.result.logm, beliefs=r.result.beliefs,
                 times=(r.t_enqueue, r.t_admit, r.t_done)) for r in recs]


def _engine(mesh, cfg=CFG):
    return D.make_sharded_engine("lbp", mesh, device=CPU,
                                 **{k: v for k, v in cfg.items()
                                    if k != "scheduler"})


def _serve(mesh, sleepy, kw, slos=None):
    """The online ``serve_async`` on ``mesh`` (its pipeline, to count the
    cycles), this rank's stream pausing before each item when it is the
    ``sleepy`` rank; the decisions published or received are counted."""
    from torch import distributed as dist
    from repro_torch.core import ServingPipeline
    from repro_torch.dist import comm
    pgms = graphs(TD, device=CPU)
    cycles = [0]
    comm.reset_stats()
    with ServingPipeline(_engine(mesh), 0, **KW, **kw) as pipe:
        pipe.on_cycle = lambda: cycles.__setitem__(0, cycles[0] + 1)
        recs = list(pipe.serve(items(pgms, slos, dist.get_rank() == sleepy)))
    return dict(records=_records(recs), chunks=pipe.stats.chunks,
                evictions=pipe.stats.evictions, cycles=cycles[0],
                decisions=comm.STATS["decisions"], role=pipe.role)


def _route(engines, stream, **kw):
    from repro_torch.serve import serve_routed
    res = serve_routed(engines, stream, 0, **kw)
    recs = res.records
    return dict(records=_records([r.record for r in recs]),
                replicas=[r.replica for r in recs],
                kinds=[r.kind for r in recs],
                stolen=[r.stolen for r in recs],
                routed=list(res.stats.routed), steals=res.stats.steals,
                stolen_n=res.stats.stolen,
                evictions=[s.evictions for s in res.replica_stats])


def _rank_main(rank, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        whole = D.make_bp_mesh(device=CPU)
        subs = [D.make_bp_mesh(ranks=r, device=CPU) for r in SUBMESHES]
        mine = next(m for m in subs if m.member)
        k = subs.index(mine)
        out = dict(mesh=[dict(ranks=m.ranks, member=m.member, size=m.size())
                         for m in subs])
        out["groups"] = _groups(whole, subs, mine)
        other = subs[1 - k]
        try:
            other.get_local_rank()
        except ValueError as e:
            out["mesh_error"] = str(e)
        eng = _engine(other)        # builds on a non-member rank ...
        try:                        # ... and refuses to run there
            eng.init(TD.ising_grid(4, 1.5, seed=0, device=CPU),
                     torch.Generator().manual_seed(0))
        except ValueError as e:
            out["init_error"] = str(e)

        t0 = time.perf_counter()
        out["whole/windowed"] = _serve(whole, sleepy=2, kw=WINDOWED)
        out["whole/deadline"] = _serve(whole, sleepy=0, kw=DEADLINE,
                                       slos=SLOS)
        # both sub-meshes at once, A windowed, B deadline; A's follower
        # sleeps, B's leader
        out["sub"] = (_serve(mine, sleepy=1, kw=WINDOWED) if k == 0 else
                      _serve(mine, sleepy=2, kw=DEADLINE, slos=SLOS))

        engines = [_engine(m) for m in subs]
        pgms = graphs(TD, device=CPU)
        out["rr"] = _route(engines, iter(pgms), routing="round_robin",
                           steal=False, **KW)
        share = [(i, p) for i, p in enumerate(pgms) if i % 2 == k]
        out["solo"] = _serve_share(mine, share)
        out["ll"] = _route([_engine(m, SKEW_CFG) for m in subs],
                           iter(skewed(TD, device=CPU)),
                           routing="least_loaded", steal=True, **SKEW_KW)
        out["ka"] = _route(engines, iter(pgms), routing="kind_affinity",
                           steal=False, **KW)
        out["dl"] = _route(engines, items(pgms, SLOS), routing="deadline",
                           steal=True, admission="deadline", **KW)
        out["seconds"] = time.perf_counter() - t0
        dist.barrier()
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _groups(whole, subs, mine):
    """What the group cache gives on this gloo world: the whole mesh and
    its host group are the world's; a sub-mesh asked for again, its host
    group, and a whole-world sharded engine make no new group."""
    import torch.distributed as dist
    from repro_torch.dist import comm
    made = len(comm._GROUPS)
    again = [D.make_bp_mesh(ranks=r, device=CPU) for r in SUBMESHES]
    BPEngine(BPConfig(scheduler="lbp", backend="sharded"), device=CPU)
    return dict(
        whole=whole.group is dist.group.WORLD is whole.host_group,
        again=[a.group is s.group for a, s in zip(again, subs)],
        host=mine.host_group is mine.group,
        made_after=len(comm._GROUPS) - made)


def _serve_share(mesh, share):
    rep = serve_async(_engine(mesh), iter(share), 0, **KW)
    return dict(records=_records(rep.records))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """[rank 0's results, rank 1's, ...] of the spawned world."""
    d = tmp_path_factory.mktemp("world4-serving")
    ctx = mp.start_processes(_rank_main, args=(str(d),), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the world did not finish in "
                               f"{JOIN_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]


# ------------------------------------------------ one device, reference --

def bridge(jpgm):
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device=CPU,
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


@pytest.fixture(scope="module")
def one():
    """rid -> the port's one-device ``serve_async`` result, for the stream
    and for the skewed stream, on the module's one thread as the ranks
    run."""
    out = {}
    for name, pgms, cfg in (("stream", graphs(TD, device=CPU), CFG),
                            ("skewed", skewed(TD, device=CPU), SKEW_CFG)):
        rep = serve_async(BPEngine(BPConfig(**cfg), device=CPU),
                          iter(enumerate(pgms)), 0, **KW)
        out[name] = {r.rid: r.result for r in rep.records}
    return out


@pytest.fixture(scope="module")
def ref():
    """rid -> the reference's one-device ``serve_async`` result, and its
    ``serve_routed`` over two one-device engines, for both streams."""
    key = jax.random.key(0)
    out = {}
    for name, pgms, cfg in (("stream", graphs(JD), CFG),
                            ("skewed", skewed(JD), SKEW_CFG)):
        jcfg = JConfig(**cfg)
        rep = JS.serve_async(JEngine(jcfg), iter(enumerate(pgms)), key, **KW)
        out[name] = {r.rid: r.result for r in rep.records}
        routed = j_serve_routed(jcfg, iter(pgms), key, replicas=2,
                                routing="round_robin", steal=False, **KW)
        out[f"routed/{name}"] = {r.rid: r.result for r in routed.records}
    return out


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same(rec, res):
    return (torch.equal(bits(rec["logm"]), bits(res.logm))
            and torch.equal(bits(rec["beliefs"]), bits(res.beliefs))
            and rec["rounds"] == int(res.rounds))


def close(rec, jres):
    n = np.asarray(jres.beliefs).shape[0]
    d = np.abs(np.exp(rec["beliefs"][:n].numpy())
               - np.exp(np.asarray(jres.beliefs)))
    return float(d.max()) < TOL


def groups_of(case):
    return [tuple(range(WORLD))] if case.startswith("whole") else SUBMESHES


# ------------------------------------------------------------ the tests --

SERVED = ["whole/windowed", "whole/deadline", "sub"]


@pytest.mark.parametrize("case", SERVED)
def test_every_rank_of_a_group_yields_the_same_records(ranks, case):
    for group in groups_of(case):
        lead = ranks[group[0]][case]
        assert len(lead["records"]) == len(graphs(TD, device=CPU))
        for r in group[1:]:
            got = ranks[r][case]
            assert [x["rid"] for x in got["records"]] == \
                [x["rid"] for x in lead["records"]]
            for a, b in zip(got["records"], lead["records"]):
                assert (a["status"], a["rounds"], a["times"]) == \
                    (b["status"], b["rounds"], b["times"])
                assert torch.equal(bits(a["logm"]), bits(b["logm"]))
                assert torch.equal(bits(a["beliefs"]), bits(b["beliefs"]))
            assert got["chunks"] == lead["chunks"]


@pytest.mark.parametrize("case", SERVED)
def test_served_records_are_bitwise_one_device(ranks, one, case):
    for group in groups_of(case):
        recs = ranks[group[0]][case]["records"]
        assert sorted(x["rid"] for x in recs) == list(range(len(recs)))
        for x in recs:
            if x["status"] == "completed":
                assert same(x, one["stream"][x["rid"]]), x["rid"]


@pytest.mark.parametrize("case", SERVED)
def test_served_records_match_the_reference(ranks, ref, case):
    for group in groups_of(case):
        for x in ranks[group[0]][case]["records"]:
            if x["status"] == "completed":
                j = ref["stream"][x["rid"]]
                assert x["rounds"] == int(j.rounds), x["rid"]
                assert close(x, j), x["rid"]


def test_deadline_runs_evict_the_hopeless_request(ranks):
    """SLO 0 cannot be met: evicted on every rank of each group, whatever
    the ranks' timing; the others complete."""
    for case, group in (("whole/deadline", 0), ("sub", 2)):
        recs = {x["rid"]: x for x in ranks[group][case]["records"]}
        assert recs[5]["status"] == "evicted"
        assert all(x["status"] == "completed" for rid, x in recs.items()
                   if rid != 5)


@pytest.mark.parametrize("case", SERVED)
def test_decisions_are_published_twice_a_cycle(ranks, case):
    """The leader publishes its decisions twice a stepped cycle and once at
    the end (``comm.STATS``), and each follower receives as many."""
    for group in groups_of(case):
        lead = ranks[group[0]][case]
        assert lead["role"] == "leader" and lead["cycles"] >= 1
        for r in group:
            got = ranks[r][case]
            assert got["cycles"] == lead["cycles"]
            assert got["decisions"] == 2 * lead["cycles"] + 1
        assert all(ranks[r][case]["role"] == "follower" for r in group[1:])


ROUTED = ["rr", "ll", "ka", "dl"]


@pytest.mark.parametrize("case", ROUTED)
def test_routed_results_are_bitwise_one_device(ranks, one, case):
    stream = "skewed" if case == "ll" else "stream"
    front = ranks[0][case]
    n = len(one[stream])
    assert sorted(x["rid"] for x in front["records"]) == list(range(n))
    assert sum(front["routed"]) == n
    for x in front["records"]:
        if x["status"] == "completed":
            assert same(x, one[stream][x["rid"]]), (case, x["rid"])


@pytest.mark.parametrize("case", ROUTED)
def test_routed_results_match_the_reference(ranks, ref, case):
    stream = "skewed" if case == "ll" else "stream"
    for x in ranks[0][case]["records"]:
        if x["status"] == "completed":
            j = ref[f"routed/{stream}"][x["rid"]]
            assert x["rounds"] == int(j.rounds), (case, x["rid"])
            assert close(x, j), (case, x["rid"])


@pytest.mark.parametrize("case", ROUTED)
def test_each_replica_group_holds_its_records(ranks, case):
    """A non-front rank's result holds its replica's records, the same on
    both ranks of the group, and the front's holds every one of them."""
    front = {x["rid"]: (x, rep) for x, rep in zip(
        ranks[0][case]["records"], ranks[0][case]["replicas"])}
    for k, group in enumerate(SUBMESHES):
        mine = [rid for rid, (_, rep) in front.items() if rep == k]
        for r in group[1:] if k == 0 else group:
            got = ranks[r][case]["records"]
            assert sorted(x["rid"] for x in got) == sorted(mine)
            for x in got:
                want = front[x["rid"]][0]
                assert x["status"] == want["status"]
                assert torch.equal(bits(x["logm"]), bits(want["logm"]))


def test_round_robin_shares_are_bitwise_their_solo_sharded_runs(ranks):
    front = ranks[0]["rr"]
    assert front["routed"] == [5, 5] and front["steals"] == 0
    by_rid = {x["rid"]: x for x in front["records"]}
    for k, group in enumerate(SUBMESHES):
        solo = ranks[group[0]]["solo"]["records"]
        assert sorted(x["rid"] for x in solo) == list(range(k, 10, 2))
        for x in solo:
            got = by_rid[x["rid"]]
            assert torch.equal(bits(got["logm"]), bits(x["logm"]))
            assert torch.equal(bits(got["beliefs"]), bits(x["beliefs"]))
            assert got["rounds"] == x["rounds"]


def test_least_loaded_steals_on_the_skewed_stream(ranks):
    ll = ranks[0]["ll"]
    assert ll["steals"] > 0 and ll["stolen_n"] == sum(ll["stolen"])


def test_kind_affinity_keeps_each_kind_on_one_replica(ranks):
    homes = {}
    ka = ranks[0]["ka"]
    for kind, rep in zip(ka["kinds"], ka["replicas"]):
        homes.setdefault(kind, set()).add(rep)
    assert len(homes) > 1 and all(len(v) == 1 for v in homes.values())


def test_routed_deadline_evicts_the_hopeless_request(ranks):
    dl = {x["rid"]: x for x in ranks[0]["dl"]["records"]}
    assert dl[5]["status"] == "evicted"
    assert sum(ranks[0]["dl"]["evictions"]) >= 1


def test_submesh_on_a_non_member_rank(ranks):
    for r, out in enumerate(ranks):
        assert [m["ranks"] for m in out["mesh"]] == list(SUBMESHES)
        assert [m["member"] for m in out["mesh"]] == [r < 2, r >= 2]
        assert all(m["size"] == 2 for m in out["mesh"])
        assert f"rank {r} is not on the mesh" in out["mesh_error"]
        assert "never run" in out["init_error"]


def test_groups_are_made_once_per_world(ranks):
    for out in ranks:
        g = out["groups"]
        assert g["whole"] and g["host"] and g["again"] == [True, True]
        assert g["made_after"] == 0


def test_submesh_without_a_world():
    """Without a process group: a sub-mesh needs one; a non-member's
    sharded engine builds and its update refuses to run."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        D.make_bp_mesh(ranks=(0, 1), device=CPU)
    outside = D.BPMesh(ranks=(2, 3), axis="bp", group=None)
    assert not outside.member and outside.size() == 2
    assert outside.host_group is None
    assert outside.mesh_dim_names == ("bp",)
    update = D.make_sharded_update(outside)
    assert update.mesh is outside
    eng = BPEngine(BPConfig(scheduler="lbp", backend=update), device=CPU)
    assert eng.update_fn is update
