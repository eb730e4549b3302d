"""Buckets of graphs: the port's ``repro_torch.core.batch`` and batched
engine against the reference's, and against its own solo runs.

- Padding, stacking, the disjoint-union fold and the bucketing policy give
  the reference's arrays bitwise (both pad on the host in numpy) and the
  same bucket indices, keys and ceilings.
- ``RidgeEffort``/``RoundsHistory`` serialize to the reference's dicts and
  predict the same rounds.
- The batched engine: LBP, RBP and RS give the reference's rounds per
  graph with beliefs within 1e-4; RnBP draws from other generators, so its
  runs are compared at the fixed point (1e-3).
- Within the port, every slot of a bucket is bitwise its solo run on
  ``batch.graph(i)`` with the same generator, chunked ``step`` is bitwise
  one run, ``run_many`` does not depend on the bucketing, and
  ``load_slot`` starts a slot's trajectory afresh.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import batch as JB
from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.core.graph import pad_pgm as j_pad_pgm
from repro.pgm import datasets as JD
from repro_torch.core import batch as TB
from repro_torch.core import BPConfig as TConfig
from repro_torch.core import BPEngine as TEngine
from repro_torch.core.graph import PGM

FIELDS = ("edge_src", "edge_dst", "edge_rev", "edge_mask", "log_psi_e",
          "log_psi_v", "state_mask", "n_states")
SCHEDULERS = [("lbp", {}), ("rbp", {"p": 1.0 / 16}), ("rs", {"p": 0.05}),
              ("rnbp", {"low_p": 0.4, "high_p": 0.9})]


def bridge(jpgm):
    """The reference graph's arrays and counts, carried into the port."""
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device="cpu",
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


def mixed_pgms():
    """The reference's 16-graph grid/chain/loop set (tests/test_batch.py)."""
    return ([JD.ising_grid(n, 2.0, seed=n) for n in (5, 6, 7, 8, 9)]
            + [JD.chain_graph(n, seed=n) for n in (30, 50, 80, 120, 160)]
            + [JD.loop_graph(n, seed=n) for n in (16, 24, 40, 64, 96, 128)])


@pytest.fixture(scope="module")
def corpus():
    jpgms = mixed_pgms() + [JD.protein_like_graph(40, seed=5)]
    return jpgms, [bridge(p) for p in jpgms]


def gens(n, base=0):
    return [TB.slot_generator(base, i, "cpu") for i in range(n)]


def assert_stacked_equal(jpgm, tpgm):
    for f in FIELDS:
        a, b = np.asarray(getattr(jpgm, f)), getattr(tpgm, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (tpgm.n_real_edges, tpgm.n_real_vertices) == \
        (jpgm.n_real_edges, jpgm.n_real_vertices)
    assert np.array_equal(np.asarray(jpgm.traced_edge_count()),
                          np.asarray(tpgm.edge_count))
    assert np.array_equal(np.asarray(jpgm.traced_vertex_count()),
                          np.asarray(tpgm.vertex_count))


def check_in_edges(pgm):
    """Every real edge sits once in its destination's row, ascending;
    dst_mask is state_mask[edge_dst]."""
    dst, real = pgm.edge_dst.numpy(), np.flatnonzero(pgm.edge_mask.numpy())
    table, mask = pgm.in_edges.numpy(), pgm.in_mask.numpy()
    assert np.array_equal(np.sort(table[mask]), real)
    assert np.array_equal(dst[table[mask]], np.nonzero(mask)[0])
    assert np.array_equal(pgm.dst_mask.numpy(),
                          pgm.state_mask.numpy()[dst].astype(np.int8))


def test_from_pgms_and_fold_bitwise(corpus):
    jpgms, tpgms = corpus
    jb, tb = JB.BatchedPGM.from_pgms(jpgms), TB.BatchedPGM.from_pgms(tpgms)
    assert (tb.size, tb.n_edges, tb.n_vertices, tb.n_states_max) == \
        (jb.size, jb.n_edges, jb.n_vertices, jb.n_states_max)
    assert_stacked_equal(jb.pgm, tb.pgm)
    union = tb.folded()
    assert tb.folded() is union                  # built once, kept
    assert_stacked_equal(jb.folded(), union)
    check_in_edges(union)
    for i in (0, 7, 16):
        assert_stacked_equal(jb.graph(i), tb.graph(i))
        check_in_edges(tb.graph(i))
    sub_j, sub_t = jb.take([3, 0, 16]), tb.take([3, 0, 16])
    assert_stacked_equal(sub_j.pgm, sub_t.pgm)
    # explicit ceilings
    kw = dict(n_edges=2048, n_vertices=200, n_states=128, n_real_edges=1500,
              n_real_vertices=150)
    assert_stacked_equal(JB.BatchedPGM.from_pgms(jpgms[:3], **kw).pgm,
                         TB.BatchedPGM.from_pgms(tpgms[:3], **kw).pgm)
    with pytest.raises(ValueError, match="empty"):
        TB.BatchedPGM.from_pgms([])


@pytest.mark.parametrize("growth,max_batch", [(2.0, None), (2.0, 3),
                                              (1.5, None), (math.inf, None),
                                              (math.inf, 5)])
def test_bucketing_matches_reference(corpus, growth, max_batch):
    jpgms, tpgms = corpus
    jbs = JB.bucket_pgms(jpgms, growth=growth, max_batch=max_batch)
    tbs = TB.bucket_pgms(tpgms, growth=growth, max_batch=max_batch)
    assert [b.indices for b in tbs] == [b.indices for b in jbs]
    for jb, tb in zip(jbs, tbs):
        assert_stacked_equal(jb.batch.pgm, tb.batch.pgm)
    for jp, tp in zip(jpgms, tpgms):
        assert TB.bucket_key(tp, growth) == JB.bucket_key(jp, growth)
        if not math.isinf(growth):
            assert TB.bucket_shape(tp, growth) == JB.bucket_shape(jp, growth)
    assert TB.group_ceilings(tpgms) == JB.group_ceilings(jpgms)
    for bad in (1.0, 0.5):
        with pytest.raises(ValueError, match="growth"):
            TB.bucket_key(tpgms[0], bad)
    with pytest.raises(ValueError, match="finite growth"):
        TB.bucket_shape(tpgms[0], math.inf)


def test_effort_models_match_reference():
    rng = np.random.default_rng(0)
    kinds = [(1024, 64, 2, 1024, 64), (4096, 256, 8, 4096, 256),
             ("routed", (512, 32, 81, 512, 32))]
    obs = [(kinds[i % 3], float(rng.uniform(0, 3)), float(rng.integers(5, 90)),
            tuple(rng.uniform(0, 1, i % 3))) for i in range(20)]
    pairs = [(JB.RoundsHistory(capacity=8), TB.RoundsHistory(capacity=8)),
             (JB.RoundsHistory(predictor="nearest", prior=12.0),
              TB.RoundsHistory(predictor="nearest", prior=12.0))]
    for jh, th in pairs:
        assert th.expect(kinds[0], 1.0, default=3.0) == \
            jh.expect(kinds[0], 1.0, default=3.0)
        for kind, score, rounds, extra in obs:
            jh.observe(kind, score, rounds, extra)
            th.observe(kind, score, rounds, extra)
        assert json.dumps(th.to_dict()) == json.dumps(jh.to_dict())
        assert len(th) == len(jh)
        again = TB.RoundsHistory.from_dict(json.loads(json.dumps(
            th.to_dict())))
        for kind in kinds + [(99, 9, 9, 99, 9)]:
            for score in (0.0, 1.3, 2.9):
                want = jh.expect(kind, score, extra=(0.5,))
                assert th.expect(kind, score, extra=(0.5,)) == want
                assert again.expect(kind, score, extra=(0.5,)) == want
            assert th.mean(kind) == jh.mean(kind)
    jm, tm = JB.RidgeEffort(l2=0.5), TB.RidgeEffort(l2=0.5)
    for kind, score, rounds, extra in obs:
        x = TB.RidgeEffort.features(kind, score, extra)
        assert np.array_equal(x, JB.RidgeEffort.features(kind, score, extra))
        jm.fit_one(x, rounds)
        tm.fit_one(x, rounds)
    assert tm.to_dict() == jm.to_dict()
    assert tm.predict(x) == jm.predict(x)
    with pytest.raises(ValueError, match="predictor"):
        TB.RoundsHistory(predictor="mean")


def test_slot_seeds_are_fixed_and_distinct():
    seeds = [TB.slot_seed(0, i) for i in range(64)] + \
        [TB.slot_seed(1, i) for i in range(64)]
    assert len(set(seeds)) == 128 and all(0 <= s < 2 ** 64 for s in seeds)
    # SplitMix64's first output from state 0
    assert TB.slot_seed(0, 0) == 0xE220A8397B1DCDAF
    a = TB.batch_generators(torch.Generator().manual_seed(5), 3, "cpu")
    b = TB.batch_generators(5, 3, "cpu")
    assert [g.initial_seed() for g in a] == [g.initial_seed() for g in b] \
        == [TB.slot_seed(5, i) for i in range(3)]
    with pytest.raises(ValueError, match="one torch.Generator per graph"):
        TB.batch_generators(a[:2], 3, "cpu")


def _beliefs_close(jbeliefs, tbeliefs, tol):
    a = np.exp(np.asarray(jbeliefs))
    b = np.exp(tbeliefs.numpy())
    assert np.abs(a - b).max() <= tol


# Settings at which every graph of the bucket ends on the reference's round.
# A float32 ulp in a residual moves a graph across eps, or RBP's greedy
# order at a near-tie, elsewhere: LBP on loop_graph(16) at eps=1e-4 ends one
# round later, RBP at p <= 1/8 some graphs a few rounds apart (ROADMAP
# queue 3).
@pytest.mark.parametrize("sched,kw,eps", [
    ("lbp", {}, 1e-3), ("rbp", {"p": 0.25}, 1e-4), ("rs", {"p": 0.05}, 1e-4)])
def test_batched_engine_matches_reference(corpus, sched, kw, eps):
    jpgms, tpgms = corpus
    jb, tb = JB.BatchedPGM.from_pgms(jpgms[:16]), \
        TB.BatchedPGM.from_pgms(tpgms[:16])
    cfg = dict(scheduler=sched, scheduler_kwargs=kw, eps=eps,
               max_rounds=600, history=False)
    jres = JEngine(JConfig(**cfg)).run(jb, JB.batch_keys(
        jax.random.key(0), jb))
    tres = TEngine(TConfig(**cfg), device="cpu").run(tb, gens(tb.size))
    assert tres.rounds.tolist() == np.asarray(jres.rounds).tolist()
    assert tres.converged.tolist() == np.asarray(jres.converged).tolist()
    _beliefs_close(jres.beliefs, tres.beliefs, 1e-4)


def test_batched_rnbp_reaches_reference_fixed_point(corpus):
    jpgms, tpgms = corpus
    pick = [0, 4, 6, 9, 12]
    jb = JB.BatchedPGM.from_pgms([jpgms[i] for i in pick])
    tb = TB.BatchedPGM.from_pgms([tpgms[i] for i in pick])
    cfg = dict(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4,
                                                   "high_p": 0.9},
               eps=1e-5, max_rounds=3000, history=False)
    jres = JEngine(JConfig(**cfg)).run(jb, JB.batch_keys(
        jax.random.key(0), jb))
    tres = TEngine(TConfig(**cfg, batch_backend="triton"),
                   device="cpu").run(tb, gens(tb.size))
    assert bool(np.all(np.asarray(jres.converged)))
    assert bool(tres.converged.all())
    _beliefs_close(jres.beliefs, tres.beliefs, 1e-3)


def _fields(res, i=None):
    out = [res.logm, res.beliefs, res.rounds, res.updates, res.converged,
           res.max_residual, res.unconverged_history]
    if isinstance(res.sched_state, torch.Tensor):
        out.append(res.sched_state)
    return out if i is None else [x[i] for x in out]


@pytest.fixture(scope="module")
def small_bucket():
    pgms = [JD.ising_grid(n, 2.5, seed=n) for n in (5, 7)] + \
        [JD.chain_graph(60, seed=2), JD.loop_graph(40, seed=3)]
    return TB.BatchedPGM.from_pgms([bridge(p) for p in pgms])


@pytest.mark.parametrize("backend,batch_backend", [
    ("ref", None), ("pallas", None), ("pallas", "pallas"),
    ("triton", "triton")])
@pytest.mark.parametrize("sched,kw", SCHEDULERS)
def test_slots_bitwise_equal_solo_runs(small_bucket, sched, kw, backend,
                                       batch_backend):
    batch = small_bucket
    eng = TEngine(TConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                          max_rounds=400, backend=backend,
                          batch_backend=batch_backend), device="cpu")
    res = eng.run(batch, gens(batch.size, base=3))
    assert bool(res.converged.all())
    for i in range(batch.size):
        solo = eng.run(batch.graph(i), TB.slot_generator(3, i, "cpu"))
        for a, b in zip(_fields(res, i), _fields(solo)):
            assert torch.equal(a, b), (sched, i)


@pytest.mark.parametrize("sched,kw,chunk", [
    ("lbp", {}, 7), ("rbp", {"p": 0.05}, 5), ("rs", {}, 5),
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}, 7),
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}, 20)])
def test_batched_chunked_step_bitwise_equals_run(small_bucket, sched, kw,
                                                 chunk):
    batch = small_bucket
    eng = TEngine(TConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                          max_rounds=300, batch_backend="triton"),
                  device="cpu")
    whole = eng.run(batch, gens(batch.size))
    state = eng.init(batch, gens(batch.size))
    steps = 0
    while not eng.finished(state):
        state = eng.step(state, chunk_rounds=chunk)
        steps += 1
    parts = eng.result(state)
    assert steps > 1
    for a, b in zip(_fields(whole), _fields(parts)):
        assert torch.equal(a, b)
    again = eng.step(state)
    assert torch.equal(again.logm, state.logm) and int(again.chunk_iters) == 0


def test_run_many_order_and_bucket_invariance(corpus):
    _, tpgms = corpus
    pgms = tpgms[:16]
    eng = TEngine(TConfig(scheduler="lbp", eps=1e-4, max_rounds=600,
                          history=False), device="cpu")
    fine = eng.run_many(pgms, 0)
    one = eng.run_many(pgms, 0, growth=math.inf)
    split = eng.run_many(pgms, 0, max_batch=3)
    assert len(fine) == len(pgms)
    for i, pgm in enumerate(pgms):
        v, s = pgm.n_real_vertices, pgm.n_states_max
        assert bool(fine[i].converged)
        assert int(fine[i].rounds) == int(one[i].rounds) == \
            int(split[i].rounds)
        for other in (one, split):
            np.testing.assert_allclose(fine[i].beliefs[:v, :s].numpy(),
                                       other[i].beliefs[:v, :s].numpy(),
                                       atol=1e-5)


def test_run_many_draws_from_each_positions_generator(corpus):
    """RnBP through ``run_many``: graph i of the stream is bitwise its solo
    run on its padded graph with ``slot_generator(base, i)``, whatever the
    bucket it lands in."""
    _, tpgms = corpus
    pgms = [tpgms[i] for i in (0, 5, 11, 16, 1)]
    eng = TEngine(TConfig(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4},
                          eps=1e-3, max_rounds=500), device="cpu")
    gen = torch.Generator().manual_seed(11)
    res = eng.run_many(pgms, gen, max_batch=2)
    for bucket in TB.bucket_pgms(pgms, max_batch=2):
        for j, gi in enumerate(bucket.indices):
            solo = eng.run(bucket.batch.graph(j), TB.slot_generator(11, gi,
                                                                    "cpu"))
            for a, b in zip(_fields(res[gi]), _fields(solo)):
                assert torch.equal(a, b), gi


@pytest.mark.parametrize("sched,kw", SCHEDULERS)
def test_load_slot_starts_a_fresh_trajectory(small_bucket, sched, kw):
    batch = small_bucket
    eng = TEngine(TConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                          max_rounds=400), device="cpu")
    whole = eng.run(batch, gens(batch.size))
    state = eng.step(eng.init(batch, gens(batch.size)), chunk_rounds=6)
    new = bridge(JD.ising_grid(6, 2.0, seed=9))
    g = torch.Generator().manual_seed(21)
    state = eng.load_slot(state, 2, new, g)
    assert state.graph.pgm.edge_count[2] == new.edge_count
    res = eng.run(batch, state=state)
    solo = eng.run(state.graph.graph(2), torch.Generator().manual_seed(21))
    for a, b in zip(_fields(res, 2), _fields(solo)):
        assert torch.equal(a, b)
    for i in (0, 1, 3):        # the other slots carry on undisturbed
        for a, b in zip(_fields(res, i), _fields(whole, i)):
            assert torch.equal(a, b)
    too_big = bridge(JD.ising_grid(12, 2.0, seed=1))
    with pytest.raises(ValueError):
        eng.load_slot(state, 0, too_big, g)


def test_pad_pgm_keeps_own_counts_in_bucket(corpus):
    """A graph padded with a raised ceiling runs as it does inside a bucket
    and as the reference runs the same padded graph."""
    jpgm = JD.ising_grid(7, 2.0, seed=3)
    jpad = j_pad_pgm(jpgm, n_edges=jpgm.n_edges + 256,
                     n_vertices=jpgm.n_vertices + 16,
                     n_states=jpgm.n_states_max, n_real_edges=400,
                     n_real_vertices=80)
    tpad = bridge(jpad)
    cfg = dict(scheduler="rbp", scheduler_kwargs={"p": 0.05}, eps=1e-4,
               max_rounds=600)
    jres = JEngine(JConfig(**cfg)).run(jpad, jax.random.key(0))
    tres = TEngine(TConfig(**cfg), device="cpu").run(
        tpad, torch.Generator().manual_seed(0))
    assert int(tres.rounds) == int(jres.rounds) and bool(tres.converged)
    _beliefs_close(jres.beliefs, tres.beliefs, 1e-4)
