"""The port on the card: the CUDA kernel and the engine's determinism.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The file
imports torch and the port only (no JAX), so it runs on a machine that has
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

- Both kernels match their plain versions on the card: sum-product within
  1e-4 absolute, max-product bitwise, identical NEG_INF entries.
- The engine on the card is deterministic: two runs and a chunked run give
  bitwise-equal results (the vertex sum uses no float atomics, and equals
  the CPU's bit for bit).
- On a bucket, every slot is bitwise its solo run with the same generator,
  through both kernels, and two bucket runs are bitwise equal.
- At every state count on a boundary of the kernels' launch plans, and at
  edge counts up to the main paths' (cut so one table stays <= 1 GiB),
  both kernels match their plain versions; and a graph's edges launched
  alone give bitwise the output they have inside a larger launch.
- The router tier: two replicas, each on a stream of its own, give results
  bitwise each share's solo run; graphs written on the submitting thread's
  stream route bitwise as host graphs do (staging waits on their entry
  event); a resilient run is bitwise the monolithic run, resumed too.
- The multi-device paths (``repro_torch.dist``, through ``chip_smoke.py``'s
  phase 17 helpers at small sizes): a world of one rank over NCCL is
  bitwise the one-device run, sharded and banded; two gloo ranks sharing
  the card stage their exchanges through the host, hold equal messages,
  and banded LBP is bitwise the one-device run.
- The LM stack (``chip_smoke.py`` phases 18 and 19 at small sizes): each
  family's serving and training paths on the card against the CPU; a
  train step's remat and resume bitwise on the card.
- Its sharded training (phase 21 at small sizes): a world of one over
  NCCL bitwise one device's steps in both modes; two gloo ranks sharing
  the card within 1e-4 of one device, their exchanges staged through the
  host.
- The edge-prelude kernel is bitwise ``messages.edge_prelude`` and its
  plain twin (as int32 bits, padded rows included) at a Tsukuba frame, a
  union of four, a 1000 x 1000 Ising grid and the S = 81 protein-like
  graph, on messages of several rounds of real RnBP runs, aligned and not;
  it launches once per update on both kernel backends' paths.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BatchedPGM, BPConfig, BPEngine, slot_generator
from repro_torch.core import messages as M
from repro_torch.kernels import edge_prelude as EP
from repro_torch.kernels import message_update as MU
from repro_torch.kernels import triton_update as TT
from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
from repro_torch.pgm import datasets as TD

pytestmark = pytest.mark.cuda
NEG_INF = -1.0e30


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def operands(e, s, seed, device):
    rng = np.random.default_rng(seed)
    valid_dst = rng.random((e, s)) < 0.7
    valid_dst[::5] = False
    valid_src = rng.random((e, s)) < 0.7
    valid_src[::7] = False
    arrays = (rng.normal(0.0, 1.0, (e, s, s)).astype(np.float32),
              np.where(valid_src, rng.normal(0.0, 2.0, (e, s)),
                       NEG_INF).astype(np.float32),
              np.where(valid_dst, rng.normal(-2.0, 1.0, (e, s)),
                       NEG_INF).astype(np.float32),
              valid_dst.astype(np.int8))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("e", [1, 1000])
@pytest.mark.parametrize("s", [2, 3, 8, 9, 32, 81])
def test_kernel_matches_plain_version(cuda, s, e):
    ops = operands(e, s, seed=s, device=cuda)
    for semiring in ("sum", "max"):
        before = TT.LAUNCHES[semiring]
        new, resid = TT.fused_update_e(*ops, semiring=semiring)
        torch.cuda.synchronize()
        assert TT.LAUNCHES[semiring] == before + 1
        pnew, presid = fused_update_e_ref(*ops, semiring)
        assert torch.equal(new == NEG_INF, pnew == NEG_INF)
        if semiring == "max":
            assert torch.equal(new, pnew) and torch.equal(resid, presid)
        else:
            assert float((new - pnew).abs().max()) <= 1e-4
            assert float((resid - presid).abs().max()) <= 1e-4


def _result_tensors(res):
    return [res.logm, res.beliefs, res.rounds, res.updates, res.converged,
            res.max_residual, res.unconverged_history]


@pytest.mark.parametrize("sched,kw", [
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}), ("rs", {}), ("rbp", {})])
def test_engine_on_card_is_deterministic(cuda, sched, kw):
    pgm = TD.ising_grid_fast(60, 2.5, seed=0, device=cuda)
    eng = BPEngine(BPConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                            max_rounds=400, backend="triton"), device=cuda)
    a = eng.run(pgm, torch.Generator(cuda).manual_seed(1))
    b = eng.run(pgm, torch.Generator(cuda).manual_seed(1))
    state = eng.init(pgm, torch.Generator(cuda).manual_seed(1))
    while not eng.finished(state):
        state = eng.step(state, chunk_rounds=23)
    c = eng.result(state)
    for x, y, z in zip(_result_tensors(a), _result_tensors(b),
                       _result_tensors(c)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_kernel_launches_fall_inside_round_spans(cuda):
    """Under a CUDA-only profile torch raises its profiler flag, the port
    records its spans, and on the profiler's clock at least 99 % of an
    Ising call's kernel launches lie inside its ``bp.round`` spans."""
    import bisect

    from torch.autograd import profiler as P
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans
    pgm = TD.ising_grid_fast(100, 2.0, seed=0, device=cuda)
    eng = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={
        "low_p": 0.4, "high_p": 0.9}, backend="triton"), device=cuda)
    eng.run(pgm, torch.Generator(cuda).manual_seed(1))   # kernels built
    torch.cuda.synchronize()
    before = {r[0] for r in spans.spans()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flag = P._is_profiler_enabled
        eng.run(pgm, torch.Generator(cuda).manual_seed(1))
        torch.cuda.synchronize()
    assert flag and not P._is_profiler_enabled
    rows = [r for r in spans.spans() if r[0] not in before]
    rounds = sorted((r[2], r[3]) for r in rows if r[1] == "bp.round")
    assert rounds
    starts = [a for a, _ in rounds]
    launches = [e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("cudaLaunchKernel")]
    assert len(launches) > 10 * len(rounds)

    def inside(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= rounds[k][1]
    share = sum(map(inside, launches)) / len(launches)
    assert share >= 0.99, share


def test_vertex_sum_is_deterministic_on_card(cuda):
    """The in-edge table fold adds in one fixed order, so the card's sum is
    the same run after run -- and bitwise the CPU's."""
    pgm = TD.protein_like_graph(120, seed=0, device=cuda)
    host = TD.protein_like_graph(120, seed=0, device="cpu")
    gen = torch.Generator(cuda).manual_seed(0)
    logm = torch.randn((pgm.n_edges, pgm.n_states_max), generator=gen,
                       device=cuda)
    first = M.vertex_logprod(pgm, logm)
    for _ in range(5):
        assert torch.equal(M.vertex_logprod(pgm, logm), first)
    assert torch.equal(first.cpu(), M.vertex_logprod(host, logm.cpu()))


@pytest.mark.parametrize("e", [1, 1000, 5000])
@pytest.mark.parametrize("s", [2, 16, 32, 81])
def test_transposed_kernel_matches_plain_version(cuda, s, e):
    logpsi, pre, logm, dmask = operands(e, s, seed=s, device=cuda)
    ops = (logpsi.permute(1, 2, 0).contiguous(), pre.t().contiguous(),
           logm.t().contiguous(), dmask.t().contiguous())
    before = MU.LAUNCHES["sum"]
    new, resid = MU.fused_update_t(*ops)
    torch.cuda.synchronize()
    assert MU.LAUNCHES["sum"] == before + 1
    pnew, presid = fused_update_t_ref(*ops)
    assert torch.equal(new == NEG_INF, pnew == NEG_INF)
    assert float((new - pnew).abs().max()) <= 1e-4
    assert float((resid - presid).abs().max()) <= 1e-4
    # the transposed kernel computes the edge-major kernel's update
    enew, eresid = TT.fused_update_e(logpsi, pre, logm, dmask)
    assert float((new.t() - enew).abs().max()) <= 1e-4
    assert float((resid - eresid).abs().max()) <= 1e-4


@pytest.mark.parametrize("backend,batch_backend", [
    ("pallas", "pallas"), ("triton", "triton"), ("pallas", None)])
@pytest.mark.parametrize("sched,kw", [
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}), ("rs", {}), ("rbp", {"p": 1 / 16}),
    ("lbp", {})])
def test_bucket_on_card_is_deterministic_and_bitwise_solo(
        cuda, sched, kw, backend, batch_backend):
    pgms = ([TD.ising_grid_fast(n, 2.5, seed=n, device=cuda)
             for n in (12, 16, 20)]
            + [TD.protein_like_graph(30, seed=1, device=cuda)])
    batch = BatchedPGM.from_pgms(pgms)
    eng = BPEngine(BPConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                            max_rounds=300, backend=backend,
                            batch_backend=batch_backend), device=cuda)
    gens = lambda: [slot_generator(7, i, cuda) for i in range(batch.size)]
    a = eng.run(batch, gens())
    b = eng.run(batch, gens())
    for x, y in zip(_result_tensors(a), _result_tensors(b)):
        assert torch.equal(x, y)
    for i in range(batch.size):
        solo = eng.run(batch.graph(i), slot_generator(7, i, cuda))
        for x, y in zip(_result_tensors(a), _result_tensors(solo)):
            assert torch.equal(x[i], y), i


PLAN_STATES = (1, 2, 8, 9, 15, 16, 17, 31, 32, 33, 51, 64, 81, 127, 128)
PLAN_EDGES = (1, 3, 7, 384, 1_024, 441_088, 1_764_352, 3_996_032)
TABLE_BYTES = 1 << 30


def device_operands(e, s, seed, device):
    """Large operands made on the card (numpy would take seconds per GiB):
    NEG_INF states, all-masked rows (every 5th edge), source rows with no
    valid state (every 7th edge)."""
    gen = torch.Generator(device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    valid_dst = torch.rand((e, s), **kw) < 0.7
    valid_dst[::5] = False
    valid_src = torch.rand((e, s), **kw) < 0.7
    valid_src[::7] = False
    return (torch.randn((e, s, s), **kw),
            torch.where(valid_src, 2.0 * torch.randn((e, s), **kw), NEG_INF),
            torch.where(valid_dst, torch.randn((e, s), **kw) - 2.0, NEG_INF),
            valid_dst.to(torch.int8))


def transposed(ops):
    logpsi, pre, logm, dmask = ops
    return (logpsi.permute(1, 2, 0).contiguous(), pre.t().contiguous(),
            logm.t().contiguous(), dmask.t().contiguous())


def assert_close(semiring, kern, plain):
    (new, resid), (pnew, presid) = kern, plain
    assert torch.equal(new == NEG_INF, pnew == NEG_INF)
    if semiring == "max":
        assert torch.equal(new, pnew) and torch.equal(resid, presid)
    else:
        assert float((new - pnew).abs().max()) <= 1e-4
        assert float((resid - presid).abs().max()) <= 1e-4


@pytest.mark.parametrize("e", PLAN_EDGES)
@pytest.mark.parametrize("s", PLAN_STATES + (200, 300))
def test_kernels_match_plain_versions_at_plan_shapes(cuda, s, e):
    e = min(e, max(1, TABLE_BYTES // (4 * s * s)))
    ops = device_operands(e, s, seed=s, device=cuda)
    if s <= TT.MAX_STATES:
        for semiring in ("sum", "max"):
            assert_close(semiring, TT.fused_update_e(*ops, semiring=semiring),
                         fused_update_e_ref(*ops, semiring))
    ops_t = transposed(ops)
    del ops
    assert_close("sum", MU.fused_update_t(*ops_t), fused_update_t_ref(*ops_t))


@pytest.mark.parametrize("s", PLAN_STATES + (200, 300))
def test_edges_bitwise_alone_and_inside_a_larger_launch(cuda, s):
    """A graph's edges give bitwise the same output launched alone (its
    solo run) and inside a larger launch (a bucket's fold), wherever they
    sit in it: an edge's arithmetic depends on S and the semiring only."""
    e = min(100_003, max(64, TABLE_BYTES // (16 * s * s)))
    ops = device_operands(e, s, seed=100 + s, device=cuda)
    ops_t = transposed(ops)
    spans = ((0, 1), (0, 7), (0, 384), (5, 33), (e - 9, 9), (e // 2, 1024))
    for lo, n in spans:
        n = min(n, e - lo)
        part = tuple(t[lo:lo + n].clone() for t in ops)   # own, aligned
        part_t = tuple(t[..., lo:lo + n].clone().contiguous() for t in ops_t)
        if s <= TT.MAX_STATES:
            for semiring in ("sum", "max"):
                full = TT.fused_update_e(*ops, semiring=semiring)
                alone = TT.fused_update_e(*part, semiring=semiring)
                assert torch.equal(alone[0], full[0][lo:lo + n]), (lo, n)
                assert torch.equal(alone[1], full[1][lo:lo + n]), (lo, n)
        full = MU.fused_update_t(*ops_t)
        alone = MU.fused_update_t(*part_t)
        assert torch.equal(alone[0], full[0][:, lo:lo + n]), (lo, n)
        assert torch.equal(alone[1], full[1][lo:lo + n]), (lo, n)


# ----------------------------------------------------------- serving path --

def _serving_timeline(rep):
    return [(r.rid, r.status, r.t_enqueue, r.t_admit, r.t_done,
             int(r.result.rounds)) for r in rep.records]


@pytest.mark.parametrize("batch_backend", ["pallas", "triton"])
def test_deadline_serving_on_card_matches_cpu(cuda, batch_backend):
    """LBP under the deadline policy and a SweepClock: the card's timeline
    and stats are the CPU plain path's, and the completed beliefs agree
    within 1e-4."""
    from repro_torch.core import SweepClock, serve_async
    cfg = BPConfig(scheduler="lbp", eps=1e-4, max_rounds=2000,
                   backend="pallas", batch_backend=batch_backend)

    def run(device):
        items = ((None, p, slo) for _, p, slo in TD.zoo_stream(
            18, seed=0, slos={"ising": 100.0, "chain": 200.0},
            device=device))
        return serve_async(BPEngine(cfg, device=device), items, 0,
                           admission="deadline", clock=SweepClock(),
                           chunk_rounds=16, max_batch=4, slots=2, prefetch=8)
    card, cpu = run(cuda), run("cpu")
    assert _serving_timeline(card) == _serving_timeline(cpu)
    assert card.stats == cpu.stats
    for a, b in zip(card.records, cpu.records):
        if a.status == "completed":
            assert float((a.result.beliefs.cpu().exp()
                          - b.result.beliefs.exp()).abs().max()) <= 1e-4


@pytest.mark.parametrize("sched,kw", [
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}), ("rlx", {"p": 1 / 32}),
    ("rlxtree", {"p": 1 / 32})])
def test_serve_on_card_equals_run_many(cuda, sched, kw):
    from repro_torch.core import serve_async
    pgms = [TD.ising_grid_fast(16, 2.5, seed=n, device=cuda)
            for n in range(5)]
    eng = BPEngine(BPConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                            max_rounds=400, backend="pallas",
                            batch_backend="pallas"), device=cuda)
    many = eng.run_many(pgms, 4, max_batch=3)
    for results in (eng.serve(pgms, 4, max_batch=2).results,
                    serve_async(eng, pgms, 4, max_batch=3, slots=2,
                                compact=True).results):
        for a, b in zip(results, many):
            for x, y in zip(_result_tensors(a), _result_tensors(b)):
                assert torch.equal(x, y)


def test_element_admitted_after_async_staging_equals_sync_staging(cuda):
    """A request staged by the non-blocking copy and admitted at once gives
    bitwise the bucket that synchronous staging gives, and the same run."""
    from repro_torch.core import ServingPipeline
    from repro_torch.core.batch import bucket_shape
    from repro_torch.core.graph import PGM, pad_pgm_arrays
    pgms = [TD.stereo_mrf(96, 128, 16, seed=k, device="cpu").pgm
            for k in range(3)]
    eng = BPEngine(BPConfig(scheduler="rnbp", eps=1e-3, max_rounds=200,
                            backend="pallas", batch_backend="pallas"),
                   device=cuda)
    pipe = ServingPipeline(eng, 0, max_batch=3)
    for rid, p in enumerate(pgms):
        pipe._stage(rid, p, 0.0)
    group, = pipe._groups.values()
    assert all(s.copy is not None for s in group.queue)
    slot = pipe._admit(group)               # right after the copies started
    e, v, s, re_, rv = bucket_shape(pgms[0])
    sync = BatchedPGM.from_pgms(
        [PGM.from_numpy(pad_pgm_arrays(p, n_edges=e, n_vertices=v,
                                       n_states=s), rv, re_, cuda,
                        edge_count=p.edge_count, vertex_count=p.vertex_count)
         for p in pgms], n_real_edges=re_, n_real_vertices=rv)
    for f in ("edge_src", "edge_dst", "edge_rev", "edge_mask", "log_psi_e",
              "log_psi_v", "state_mask", "n_states", "in_edges", "in_mask",
              "dst_mask"):
        assert torch.equal(getattr(slot.state.graph.pgm, f),
                           getattr(sync.pgm, f)), f
    got = eng.run(slot.state.graph, state=slot.state)
    want = eng.run(sync, [slot_generator(0, i, cuda) for i in range(3)])
    for x, y in zip(_result_tensors(got), _result_tensors(want)):
        assert torch.equal(x, y)


def _router_stream(device):
    """Small RnBP stream of two shape families on ``device``."""
    out = []
    for k in range(4):
        out.append(TD.ising_grid(8, 1.8, seed=k, device=device))
        out.append(TD.chain_graph(40 + k, seed=k, device=device))
    return out


def _router_engines(cuda, n=2):
    return [BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={
        "low_p": 0.4, "high_p": 0.9}, eps=1e-3, max_rounds=300,
        backend="triton", batch_backend="pallas"), device=cuda)
        for _ in range(n)]


def test_two_replicas_on_their_streams_equal_solo_serve_async(cuda):
    """Round robin without stealing on the card: each replica runs on a
    non-default stream of its own, and every record is bitwise its
    share's solo ``serve_async`` run."""
    from repro_torch.core import serve_async
    from repro_torch.serve import Router
    stream = _router_stream("cpu")
    engines = _router_engines(cuda)
    router = Router(engines, 0, routing="round_robin", max_batch=2,
                    chunk_rounds=16)
    streams = [r.stream for r in router.replicas]
    assert all(s is not None and s != torch.cuda.default_stream(cuda)
               for s in streams) and streams[0] != streams[1]
    by_rid = {r.rid: r.result for r in router.serve(iter(stream))}
    assert sorted(by_rid) == list(range(len(stream)))
    for k in range(2):
        share = [(i, p) for i, p in enumerate(stream) if i % 2 == k]
        for rec in serve_async(engines[0], iter(share), 0, max_batch=2,
                               chunk_rounds=16).records:
            for x, y in zip(_result_tensors(by_rid[rec.rid]),
                            _result_tensors(rec.result)):
                assert torch.equal(x, y)


def test_graphs_made_on_the_card_route_as_host_graphs(cuda):
    """Graphs written on the submitting thread's stream behind a long
    kernel, then routed to replicas on other streams: the replicas' reads
    wait on the entry event, so the results are bitwise those of the same
    graphs made on the host."""
    import dataclasses
    from repro_torch.serve import serve_routed
    host = _router_stream("cpu")

    def made_on_card():
        for p in host:
            dev = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
            dev = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
                   for k, v in dev.items()}
            torch.cuda._sleep(50_000_000)   # the writes below wait on this
            yield type(p)(**{k: v.clone() if isinstance(v, torch.Tensor)
                             else v for k, v in dev.items()})
    engines = _router_engines(cuda)
    want = serve_routed(engines, iter(host), 0, routing="round_robin",
                        max_batch=2, chunk_rounds=16).results
    got = serve_routed(engines, made_on_card(), 0, routing="least_loaded",
                       steal=True, max_batch=2, chunk_rounds=16).results
    for a, b in zip(got, want):
        for x, y in zip(_result_tensors(a), _result_tensors(b)):
            assert torch.equal(x, y)


def test_resilient_run_on_card_is_bitwise_monolithic(cuda, tmp_path):
    import os
    import shutil
    from repro_torch.core.schedulers import RnBP
    from repro_torch.ft import run_bp_resilient
    pgm = TD.ising_grid_fast(64, 2.5, seed=0, device=cuda)
    sched = RnBP(low_p=0.4, high_p=0.9)
    eng = BPEngine(BPConfig(scheduler=sched, eps=1e-3, max_rounds=2000,
                            backend="triton"), device=cuda)
    want = eng.run(pgm, torch.Generator(device=cuda).manual_seed(0))

    def resilient():
        return run_bp_resilient(
            pgm, sched, torch.Generator(device=cuda).manual_seed(0),
            max_rounds=2000, rounds_per_chunk=9, ckpt_dir=str(tmp_path),
            backend="triton")
    got = resilient()
    for x, y in zip(_result_tensors(got), _result_tensors(want)):
        assert torch.equal(x, y)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    for s in steps[len(steps) // 2 + 1:]:
        shutil.rmtree(tmp_path / f"step_{s:09d}")
    again = resilient()
    assert torch.equal(again.logm, want.logm)
    assert int(again.rounds) == int(want.rounds) - steps[len(steps) // 2]


def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_nccl_world_of_one_is_bitwise_the_one_device_run(cuda, tmp_path):
    cs = _chip_smoke()
    pgm = TD.ising_grid_fast(64, 2.5, seed=0, device=cuda)
    res, _ = cs.run_engine(pgm, cuda, scheduler="rnbp",
                           scheduler_kwargs=cs.MAIN_KW, backend="triton")
    out = cs.phase_dist_one(cuda, pgm, res, tmp_path / "store",
                            backend="nccl", banded_rounds=60)
    assert out["transport"] == "nccl"
    s, b = out["sharded"], out["banded"]
    assert s["bitwise"] and s["launches"] >= s["rounds"] > 0
    assert b["bitwise"] and b["launches"] >= b["rounds"] > 0
    assert s["staged_bytes"] == 0


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    cs = _chip_smoke()
    out = cs.phase_dist_gloo(cuda, tmp_path / "gloo", n=32, size=2)
    assert out["transport"] == "gloo, host-staged"
    assert out["ranks_bitwise_equal"] and out["banded"]["bitwise"]
    assert out["lbp"]["staged_bytes"] > 0
    assert out["lbp"]["launches"] >= out["lbp"]["rounds"]


@pytest.mark.parametrize("arch", ["qwen3_4b", "granite_moe_3b_a800m",
                                  "deepseek_v3_671b", "mamba2_130m",
                                  "hymba_1_5b", "whisper_medium"],
                         ids=["dense", "moe", "mla", "ssm", "hybrid",
                              "enc_dec"])
def test_lm_family_on_card_matches_cpu(cuda, arch):
    """The LM stack on the card: prefill logits and caches and 8 decode
    steps within 1e-4 of the CPU on the same weights, MoE routing equal
    (``chip_smoke.py`` phase 18 (a)); a decode step with the position on
    the card reads the host only for the MoE group sizes."""
    from repro_torch import configs as TC
    cs = _chip_smoke()
    cfg = TC.get(arch).reduced()
    out = cs.lm_card_vs_cpu(cfg, cuda, 2, 8, 8)
    assert out["decode_err"] <= cs.LM_TOL
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    assert out["moe_routings"] == n_moe * 9     # prefill + 8 decode steps
    assert out["syncs_per_step"] <= n_moe


@pytest.mark.parametrize("arch", ["qwen3_4b", "granite_moe_3b_a800m",
                                  "deepseek_v3_671b", "mamba2_130m",
                                  "whisper_medium"],
                         ids=["dense", "moe", "mla_mtp", "ssm", "enc_dec"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch, tmp_path):
    """The LM stack's training on the card (``chip_smoke.py`` phase 19
    (a)): forward_train's metrics, every gradient leaf and one AdamW update
    within 1e-4 of the CPU; remat on == off and a resumed run == the
    unbroken one, bitwise on the card; a dense train step reads nothing
    back to the host, a ragged MoE one its group sizes twice per MoE layer
    (forward and recompute)."""
    from repro_torch import configs as TC
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticLM
    cs = _chip_smoke()
    cfg = TC.get(arch).reduced()
    out = cs.lm_train_card_vs_cpu(cfg, cuda, b=2, s=16, steps=5, ckpt_at=3,
                                  ckpt_dir=tmp_path / "ckpt")
    assert out["grad_err"] <= cs.LM_TOL and out["resumed_bitwise"]
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    assert out["syncs_per_step"] <= 2 * n_moe
    shape = InputShape("train", 16, 2, "train")
    card = SyntheticLM(cfg, shape, device=cuda).batch(4)
    host = SyntheticLM(cfg, shape, device="cpu").batch(4)
    assert all(torch.equal(card[k].cpu(), host[k]) for k in host)


def test_lm_sharded_world_of_one_is_bitwise_on_card(cuda, tmp_path):
    """The sharded serving path on a world of one over NCCL (mesh (1, 1),
    ``chip_smoke.py`` phase 20 (a)): prefill logits, caches and 8 decode
    steps bitwise the one-device card run."""
    cs = _chip_smoke()
    families = cs.shard_families((("qwen3_4b", None), ("pixtral_12b", None),
                                  ("granite_moe_3b_a800m", "sharded")))
    refs = {cs.shard_key(c): cs.family_run(cs.one_device_cfg(c), cuda,
                                           **cs.LM_SHARD_FAMILY)
            for c in families}
    out = cs.lm_shard_one(cuda, tmp_path / "store", families, refs,
                          cs.LM_SHARD_FAMILY, "nccl")
    assert all(out.values()) and len(out) == 3


def test_lm_sharded_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Phase 20 at small sizes on the card: two gloo ranks sharing it on
    meshes (1, 2) and (2, 1) within 1e-4 of one device, ranks bitwise
    equal, DeepSeek-V3's MLA blocks among them (tensor-parallel since
    they stopped raising over "model"); a two-layer reduced Granite in
    bf16 served whole and over the ranks with the "sharded" dispatch."""
    import dataclasses
    from repro_torch import configs as TC
    cs = _chip_smoke()
    granite = TC.get("granite_moe_3b_a800m").reduced()
    out = cs.phase_lm_shard(
        cuda, tmp_path / "shard",
        families=cs.shard_families((("qwen3_4b", None),
                                    ("granite_moe_3b_a800m", "sharded"),
                                    ("deepseek_v3_671b", None))),
        moe_cfg=dataclasses.replace(granite, dtype="bfloat16"),
        family=cs.LM_SHARD_FAMILY,
        serve=dict(b=2, prefill_len=64, prompt_len=8, gen=4, trace_steps=2),
        sharded=dict(s=16, steps=4), size=2)
    assert all(f["err"] <= cs.LM_TOL for f in out["families"].values())
    assert any(k.startswith("deepseek-v3-671b-reduced")
               for k in out["families"])
    assert out["served"]["world_of_one_bitwise"]
    assert out["served"]["syncs_per_step"] == 2       # one per MoE layer
    assert out["served"]["decode_vs_prefill"]["float32"]["rel"] <= cs.LM_TOL
    c = out["sharded"]
    assert c["float32/pinned"]["step_rel"] <= cs.LM_TOL
    assert c["bfloat16/own"]["transport"] == "gloo, host-staged"
    assert c["bfloat16/own"]["staged_bytes_per_step"] > 0


def test_lm_sharded_train_world_of_one_is_bitwise_on_card(cuda, tmp_path):
    """Sharded training on a world of one over NCCL (mesh (1, 1),
    ``chip_smoke.py`` phase 21 (a)): 3 steps bitwise the one-device card
    run -- metrics, step 0's gradients, masters and moments -- under
    "tp" and "fsdp"."""
    cs = _chip_smoke()
    from repro_torch.ft import ElasticMesh
    keep = ("tp qwen3-4b-reduced", "tp granite-moe-3b-a800m-reduced/sharded",
            "fsdp whisper-medium-reduced", "fsdp deepseek-v3-671b-reduced")
    cases = [c for c in cs.strain_cases() if c[0] in keep]
    with cs.world("nccl", tmp_path / "store"):
        mesh = ElasticMesh(1, device=cuda).current()
        for key, mode, cfg in cases:
            a = cs.strain_run(cs.one_device_cfg(cfg), cuda,
                              **cs.LM_STRAIN_FAMILY)
            b = cs.strain_run(cfg, cuda, mesh=mesh, mode=mode,
                              **cs.LM_STRAIN_FAMILY)
            cs.strain_same(key, b[1:], a[1:])
    assert len(cases) == 4


def test_lm_sharded_train_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Phase 21 at small sizes on the card: two gloo ranks sharing it
    within 1e-4 of one device, ranks bitwise; a two-layer reduced Granite
    in float32 and in bf16 trained over the ranks, staged through the
    host."""
    import dataclasses
    from repro_torch import configs as TC
    cs = _chip_smoke()
    keep = ("tp gemma-7b-reduced", "tp granite-moe-3b-a800m-reduced/ragged",
            "fsdp hymba-1.5b-reduced", "fsdp pixtral-12b-reduced")
    granite = dataclasses.replace(TC.get("granite_moe_3b_a800m").reduced(),
                                  moe_dispatch="sharded")
    out = cs.phase_lm_strain(
        cuda, tmp_path / "strain",
        cases=[c for c in cs.strain_cases() if c[0] in keep],
        wide_cfg=granite, full_cfg=dataclasses.replace(granite,
                                                       dtype="bfloat16"),
        wide=dict(layers=2, b=2, s=64, steps=3, base_lr=1e-4, warmup=1),
        full=dict(b=2, s=64, steps=3, base_lr=1e-3, warmup=1))
    assert all(out["one"].values()) and len(out["one"]) == 4
    assert all(f["leaf_err"] <= cs.LM_TOL
               for f in out["families"].values())
    assert all(w["leaf_err"] <= cs.LM_TOL for w in out["wide"].values())
    c = out["full"]
    assert c["transport"] == "gloo, host-staged"
    assert c["staged_bytes_per_step"] > 0 and c["eval_drop"] > 0


def test_docs_pages_run_on_the_card(cuda):
    """The port's pages of the docs' executable spec on the card
    (``chip_smoke.py`` phase 26, README's block cut to small graphs):
    every block's own asserts, ``sharding.md`` on an NCCL world of one,
    ``kernels.md``'s ``fused_update_e`` against its plain version (sum
    within 1e-4, max bitwise), and each kernel launched."""
    cs = _chip_smoke()
    block = cs.readme_port_block()
    for full, small in (("ising_grid_fast(1000", "ising_grid_fast(64"),
                        ("height=288, width=384, n_disp=16",
                         "height=24, width=32, n_disp=8")):
        assert full in block
        block = block.replace(full, small)
    out = cs.phase_docs(cuda, readme=block)
    assert sum(v["blocks"] for v in out["pages"].values()) == 30
    assert out["kernel_check"]["fused_update_e/sum"] <= cs.SUM_TOL
    assert out["kernel_check"]["fused_update_e/max"] == 0.0
    assert all(n > 0 for n in out["launches"].values())
    assert out["pages"]["kernels.md"]["launches"]["fused_update_e/max"] == 1


# ------------------------------------------------------------ edge prelude --

@pytest.fixture(scope="module")
def prelude_graphs():
    """The main paths' prelude shapes on the card: a Tsukuba-size stereo
    frame (S = 16), a bucket of four, a 1000 x 1000 Ising grid (S = 2) and
    the protein-like MRF of the zoo (S = 81, in-degree up to 15)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    frames = [TD.stereo_mrf(288, 384, 16, seed=i, device=dev).pgm
              for i in range(4)]
    return {"tsukuba": frames[0],
            "tsukuba_x4": BatchedPGM.from_pgms(frames),
            "ising1000": TD.ising_grid_fast(1000, 2.0, seed=0, device=dev),
            "protein_s81": TD.protein_like_graph(seed=0, device=dev)}


def unaligned(t, floats):
    """A contiguous copy of ``t`` starting ``floats`` floats past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[floats:floats + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("name", ["tsukuba", "tsukuba_x4", "ising1000",
                                  "protein_s81"])
def test_edge_prelude_kernel_is_bitwise_the_torch_prelude(prelude_graphs,
                                                          name):
    cs = _chip_smoke()
    dev = torch.device("cuda")
    graph = prelude_graphs[name]
    pgm = graph.folded() if isinstance(graph, BatchedPGM) else graph
    sets = cs.rnbp_messages(graph, dev, rounds=(0, 5, 20))
    sets.append(unaligned(sets[-1], 1))
    sets.append(unaligned(sets[-2], 2))
    for logm in sets:
        before = EP.LAUNCHES["edge_prelude"]
        pre = EP.edge_prelude(pgm, logm)
        torch.cuda.synchronize()
        assert EP.LAUNCHES["edge_prelude"] == before + 1
        assert cs.bitwise(pre, M.edge_prelude(pgm, logm))
        assert cs.bitwise(pre, EP.edge_prelude_ref(
            logm, pgm.log_psi_v, pgm.state_mask, pgm.in_edges, pgm.in_mask,
            pgm.edge_src, pgm.edge_rev, pgm.edge_mask))


@pytest.mark.parametrize("backend", ["triton", "pallas"])
def test_edge_prelude_launches_once_per_update(cuda, backend):
    """One prelude launch per update kernel launch, on a graph's run and
    on a bucket's fold; and one for a max-product update."""
    from repro_torch.kernels import ops as TO
    pgm = TD.ising_grid_fast(40, 2.5, seed=0, device=cuda)
    batch = BatchedPGM.from_pgms([TD.stereo_mrf(12, 16, 8, seed=i,
                                                device=cuda).pgm
                                  for i in range(3)])
    eng = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={
        "low_p": 0.4, "high_p": 0.9}, eps=1e-3, max_rounds=60,
        backend=backend), device=cuda)
    counts = TT.LAUNCHES if backend == "triton" else MU.LAUNCHES
    for graph, gen in ((pgm, torch.Generator(cuda).manual_seed(0)),
                       (batch, [slot_generator(0, i, cuda)
                                for i in range(batch.size)])):
        EP.reset_launch_counts()
        TT.reset_launch_counts()
        MU.reset_launch_counts()
        eng.run(graph, gen)
        torch.cuda.synchronize()
        assert counts["sum"] > 0
        assert EP.LAUNCHES["edge_prelude"] == counts["sum"]
    EP.reset_launch_counts()
    TT.reset_launch_counts()
    TO.make_triton_update(semiring="max")(pgm, M.init_messages(pgm))
    torch.cuda.synchronize()
    assert EP.LAUNCHES["edge_prelude"] == TT.LAUNCHES["max"] == 1
