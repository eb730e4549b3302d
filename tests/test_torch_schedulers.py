"""Frontier selection: the port's schedulers against the reference's.

Given identical residuals, LBP, RBP and RS must return bitwise-equal
frontier masks. RnBP draws random numbers, and torch's generators differ
from JAX's threefry, so it is compared through ``select_with``: the port
gets the very uniforms the reference draws from its key, and masks and
controller state must then be bitwise equal.

Frontier sizes come from a graph's own real counts, not the static
ceilings a bucket raises: on a graph padded with ``pad_pgm(...,
n_real_edges=ceiling, n_real_vertices=ceiling)`` and on a whole bucket
(the reference vmaps ``select``), the masks are still the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import schedulers as JS
from repro.core.batch import BatchedPGM as JBatch
from repro.core.graph import pad_pgm as j_pad_pgm
from repro.pgm import datasets as JD
from repro_torch.core import schedulers as TS
from repro_torch.core.batch import BatchedPGM as TBatch
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import frontier_size

EPS = 1e-3


def bridge(jpgm):
    """The reference graph's arrays and its own counts, carried into the
    port."""
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices,
                          jpgm.n_real_edges, device="cpu",
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


@pytest.fixture(scope="module", params=["ising", "protein", "chain"])
def graphs(request):
    jpgm = {"ising": lambda: JD.ising_grid(9, 2.0, seed=0),
            "protein": lambda: JD.protein_like_graph(40, seed=1),
            "chain": lambda: JD.chain_graph(300, seed=2)}[request.param]()
    return jpgm, bridge(jpgm)


def residual_sets(n_edges, seed=0):
    """Residual vectors with ties, exact zeros, values around EPS and
    nonzero entries on padded edges."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(0.01, n_edges).astype(np.float32)
    tied = r.copy()
    tied[rng.random(n_edges) < 0.3] = np.float32(0.02)
    sparse = np.where(rng.random(n_edges) < 0.8, 0.0, r).astype(np.float32)
    near = (EPS * rng.uniform(0.5, 1.5, n_edges)).astype(np.float32)
    return [r, tied, sparse, near, np.zeros(n_edges, np.float32)]


def unconverged(jpgm, r):
    return int(np.sum((r >= EPS) & np.asarray(jpgm.edge_mask)))


@pytest.mark.parametrize("name,kwargs", [
    ("lbp", {}), ("rbp", {}), ("rbp", {"p": 0.05}), ("rbp", {"p": 0.3}),
    ("rs", {}), ("rs", {"p": 0.05, "h": 1, "inner_sweeps": 1}),
    ("rs", {"p": 0.2, "h": 3, "inner_sweeps": 3})])
def test_deterministic_frontiers_bitwise(graphs, name, kwargs):
    jpgm, tpgm = graphs
    js, ts = JS.get_scheduler(name, **kwargs), TS.get_scheduler(name, **kwargs)
    assert TS.scheduler_spec(ts) == JS.scheduler_spec(js)
    for r in residual_sets(jpgm.n_edges):
        u = unconverged(jpgm, r)
        jf, _ = js.select(jpgm, jnp.asarray(r), EPS, jax.random.key(0),
                          js.init(jpgm), jnp.int32(u))
        tf, _ = ts.select(tpgm, torch.from_numpy(r), EPS, None,
                          ts.init(tpgm), torch.tensor(u, dtype=torch.int32))
        assert tf.dtype == torch.bool
        assert np.array_equal(np.asarray(jf), tf.numpy())


@pytest.mark.parametrize("kwargs", [{}, {"low_p": 0.4, "high_p": 0.9},
                                    {"low_p": 0.1, "high_p": 0.5,
                                     "ratio_threshold": 0.5}])
def test_rnbp_bitwise_given_same_draws(graphs, kwargs):
    jpgm, tpgm = graphs
    js, ts = JS.RnBP(**kwargs), TS.RnBP(**kwargs)
    jstate, tstate = js.init(jpgm), ts.init(tpgm)
    assert np.float32(jstate) == tstate.item()
    e = jpgm.n_edges
    # alternate stalling and fast-shrinking rounds: both p modes fire
    for i, r in enumerate(residual_sets(e, seed=5) * 2):
        key = jax.random.key(i)
        draws = np.array(jax.random.uniform(key, (e,)))
        u = unconverged(jpgm, r) if i % 2 else max(unconverged(jpgm, r) // 3, 0)
        jf, jstate = js.select(jpgm, jnp.asarray(r), EPS, key, jstate,
                               jnp.int32(u))
        tf, tstate = ts.select_with(tpgm, torch.from_numpy(r), EPS,
                                    torch.from_numpy(draws), tstate,
                                    torch.tensor(u, dtype=torch.int32))
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.float32(jstate) == tstate.item()


def test_rnbp_select_draws_from_generator():
    tpgm = bridge(JD.ising_grid(5, 2.0, seed=0))
    s = TS.RnBP(low_p=0.5, high_p=0.5)
    r = torch.ones(tpgm.n_edges)
    unc = torch.tensor(tpgm.n_real_edges, dtype=torch.int32)
    a, _ = s.select(tpgm, r, EPS, torch.Generator().manual_seed(3),
                    s.init(tpgm), unc)
    b, _ = s.select(tpgm, r, EPS, torch.Generator().manual_seed(3),
                    s.init(tpgm), unc)
    c, _ = s.select(tpgm, r, EPS, torch.Generator().manual_seed(4),
                    s.init(tpgm), unc)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not bool(a[~tpgm.edge_mask].any())


@pytest.mark.parametrize("p,count", [(1 / 256, 159_200), (0.3, 37),
                                     (0.5, 5), (1 / 128, 40_000),
                                     (0.1, 25)])
def test_frontier_size_rounds_like_reference(p, count):
    k_max = max(1, int(round(p * count)))
    ref = int(jnp.clip(jnp.round(p * jnp.float32(count)).astype(jnp.int32),
                       1, k_max))
    assert frontier_size(p, count, k_max) == ref


def test_registry_surface():
    assert TS.list_schedulers() == JS.list_schedulers() == [
        "lbp", "rbp", "rlx", "rlxtree", "rnbp", "rs"]
    for name in ("rlx", "rlxtree"):
        sched = TS.get_scheduler(name, queues=4, p=0.1)
        assert TS.scheduler_spec(sched) == JS.scheduler_spec(
            JS.get_scheduler(name, queues=4, p=0.1))
        assert TS.get_scheduler(*TS.scheduler_spec(sched)[:1],
                                **TS.scheduler_spec(sched)[1]) == sched
    with pytest.raises(ValueError) as je:
        JS.get_scheduler("srbp")
    with pytest.raises(ValueError, match="host-serial baseline") as te:
        TS.get_scheduler("srbp")
    assert str(te.value) == str(je.value)
    with pytest.raises(KeyError, match="unknown scheduler 'nope'"):
        TS.get_scheduler("nope")
    inst = TS.RBP(p=0.1)
    assert TS.get_scheduler(inst) is inst
    with pytest.raises(ValueError):
        TS.get_scheduler(inst, p=0.2)


def padded_to_ceiling(jpgm, ceiling=4096):
    """The graph re-padded as a bucket pads it: 2x the edges, 64 more
    vertices, and static ceilings far above its own counts."""
    jpad = j_pad_pgm(jpgm, n_edges=2 * jpgm.n_edges,
                     n_vertices=jpgm.n_vertices + 64,
                     n_states=jpgm.n_states_max, n_real_edges=ceiling,
                     n_real_vertices=ceiling)
    return jpad, bridge(jpad)


@pytest.mark.parametrize("name,kwargs", [
    ("rbp", {"p": 0.05}), ("rbp", {"p": 0.3}), ("rs", {"p": 0.05}),
    ("rs", {"p": 0.2, "h": 1, "inner_sweeps": 1})])
def test_padded_graph_frontiers_follow_own_counts(graphs, name, kwargs):
    jpad, tpad = padded_to_ceiling(graphs[0])
    assert (tpad.edge_count, tpad.vertex_count) == \
        (int(jpad.edge_count), int(jpad.vertex_count))
    assert tpad.n_real_edges == tpad.n_real_vertices == 4096
    js, ts = JS.get_scheduler(name, **kwargs), TS.get_scheduler(name, **kwargs)
    for r in residual_sets(jpad.n_edges, seed=2):
        u = unconverged(jpad, r)
        jf, _ = js.select(jpad, jnp.asarray(r), EPS, jax.random.key(0), (),
                          jnp.int32(u))
        tf, _ = ts.select(tpad, torch.from_numpy(r), EPS, None, (),
                          torch.tensor(u, dtype=torch.int32))
        assert np.array_equal(np.asarray(jf), tf.numpy())


def test_padded_graph_rnbp_follows_own_counts(graphs):
    jpad, tpad = padded_to_ceiling(graphs[0])
    js, ts = JS.RnBP(low_p=0.4, high_p=0.9), TS.RnBP(low_p=0.4, high_p=0.9)
    jstate, tstate = js.init(jpad), ts.init(tpad)
    assert np.float32(jstate) == tstate.item() == float(jpad.edge_count)
    for i, r in enumerate(residual_sets(jpad.n_edges, seed=4)):
        key = jax.random.key(i)
        draws = np.array(jax.random.uniform(key, (jpad.n_edges,)))
        u = unconverged(jpad, r)
        jf, jstate = js.select(jpad, jnp.asarray(r), EPS, key, jstate,
                               jnp.int32(u))
        tf, tstate = ts.select_with(tpad, torch.from_numpy(r), EPS,
                                    torch.from_numpy(draws), tstate,
                                    torch.tensor(u, dtype=torch.int32))
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.float32(jstate) == tstate.item()


@pytest.fixture(scope="module")
def buckets():
    """One bucket of graphs of different sizes (own counts below the
    bucket's ceilings), in both packages."""
    jpgms = [JD.ising_grid(n, 2.0, seed=n) for n in (4, 9)] + \
        [JD.chain_graph(90, seed=1), JD.protein_like_graph(12, seed=3)]
    jb = JBatch.from_pgms(jpgms)
    tb = TBatch.from_pgms([bridge(p) for p in jpgms])
    return jb, tb


def batch_residuals(jb, seed):
    rows = [residual_sets(jb.n_edges, seed=seed + i)[i % 4]
            for i in range(jb.size)]
    r = np.stack(rows)
    u = np.sum((r >= EPS) & np.asarray(jb.pgm.edge_mask), axis=1)
    return r, u.astype(np.int32)


@pytest.mark.parametrize("name,kwargs", [
    ("lbp", {}), ("rbp", {"p": 0.05}), ("rbp", {"p": 0.3}),
    ("rs", {"p": 0.05}), ("rs", {"p": 0.2, "h": 3, "inner_sweeps": 3})])
def test_batched_select_matches_vmapped_reference(buckets, name, kwargs):
    jb, tb = buckets
    js, ts = JS.get_scheduler(name, **kwargs), TS.get_scheduler(name, **kwargs)
    vselect = jax.vmap(lambda p, r, u: js.select(p, r, EPS, jax.random.key(0),
                                                 (), u)[0])
    for seed in (0, 10):
        r, u = batch_residuals(jb, seed)
        jf = vselect(jb.pgm, jnp.asarray(r), jnp.asarray(u))
        tf, _ = ts.select_batch(tb, torch.from_numpy(r), EPS,
                                [None] * tb.size, ts.init_batch(tb),
                                torch.from_numpy(u))
        assert tf.shape == (tb.size, tb.n_edges)
        assert np.array_equal(np.asarray(jf), tf.numpy())


def test_batched_rnbp_matches_vmapped_reference(buckets):
    jb, tb = buckets
    js, ts = JS.RnBP(low_p=0.4, high_p=0.9), TS.RnBP(low_p=0.4, high_p=0.9)
    jstate = jax.vmap(js.init)(jb.pgm)
    tstate = ts.init_batch(tb)
    assert np.array_equal(np.asarray(jstate), tstate.numpy())
    vselect = jax.vmap(lambda p, r, k, st, u: js.select(p, r, EPS, k, st, u))
    for i in range(4):
        r, u = batch_residuals(jb, 20 + i)
        keys = jax.random.split(jax.random.key(i), jb.size)
        draws = np.stack([np.array(jax.random.uniform(k, (jb.n_edges,)))
                          for k in keys])
        jf, jstate = vselect(jb.pgm, jnp.asarray(r), keys, jstate,
                             jnp.asarray(u))
        tf, tstate = ts.select_with(tb.pgm, torch.from_numpy(r), EPS,
                                    torch.from_numpy(draws), tstate,
                                    torch.from_numpy(u))
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(jstate), tstate.numpy())


def test_batched_rnbp_draws_one_row_per_live_graph(buckets):
    """Row b of a bucket's draw is what graph b's generator gives alone; a
    graph with no generator (budget spent) draws nothing."""
    _, tb = buckets
    s = TS.RnBP(low_p=0.5, high_p=0.5)
    r = torch.ones(tb.size, tb.n_edges)
    unc = torch.tensor(tb.pgm.edge_count, dtype=torch.int32)
    gens = [torch.Generator().manual_seed(i) for i in range(tb.size)]
    gens[1] = None
    f, _ = s.select_batch(tb, r, EPS, gens, s.init_batch(tb), unc)
    for b in (0, 2, 3):
        solo, _ = s.select(tb.graph(b), r[b], EPS,
                           torch.Generator().manual_seed(b),
                           s.init(tb.graph(b)), unc[b])
        assert torch.equal(f[b], solo)
    assert not bool(f[1].any())


# ------------------------------------------------------ relaxed family --

from repro.core.schedulers import rlx as JRLX  # noqa: E402
from repro_torch.core import BPConfig as TConfig  # noqa: E402
from repro_torch.core import BPEngine as TEngine  # noqa: E402
from repro_torch.core.batch import slot_generator  # noqa: E402
from repro_torch.core.schedulers import rlx as TRLX  # noqa: E402

RELAXED = [("rlx", {}), ("rlx", {"queues": 16, "p": 0.05, "sample": 0.3}),
           ("rlxtree", {}),
           ("rlxtree", {"queues": 4, "p": 0.1, "sample": 0.7})]


@pytest.mark.parametrize("n_edges,queues", [
    (256, 8), (384, 5), (1000, 7), (7, 16), (128, 1), (4096, 128)])
def test_queue_count_matches_reference(n_edges, queues):
    assert TRLX.queue_count(n_edges, queues) == \
        JRLX.queue_count(n_edges, queues)


@pytest.mark.parametrize("k", [1, 3, 17, 64])
@pytest.mark.parametrize("seed", range(3))
def test_queue_threshold_bitwise(seed, k):
    rng = np.random.default_rng(seed)
    res2 = rng.exponential(0.01, (8, 64)).astype(np.float32)
    res2[rng.random(res2.shape) < 0.3] = np.float32(0.02)      # ties
    res2[rng.random(res2.shape) < 0.2] = 0.0
    res2[3] = 0.0                                              # empty queue
    want = np.asarray(JRLX.queue_threshold(jnp.asarray(res2), k))
    got = TRLX.queue_threshold(torch.from_numpy(res2), k)
    assert np.array_equal(want, got.numpy())
    # per-graph k on a (B, Q, L) view: each row is its own graph's
    ks = torch.tensor([k, 1, 5])
    rows = np.stack([res2, res2[::-1].copy(), res2 * 3])
    got_b = TRLX.queue_threshold(torch.from_numpy(rows), ks)
    for b in range(3):
        want_b = JRLX.queue_threshold(jnp.asarray(rows[b]), int(ks[b]))
        assert np.array_equal(np.asarray(want_b), got_b[b].numpy())


@pytest.mark.parametrize("name,kwargs", RELAXED)
def test_relaxed_frontiers_bitwise_given_same_draws(graphs, name, kwargs):
    jpgm, tpgm = graphs
    js, ts = JS.get_scheduler(name, **kwargs), TS.get_scheduler(name, **kwargs)
    jstate, tstate = js.init(jpgm), ts.init(tpgm)
    if name == "rlxtree":               # the permutation is the reference's
        assert np.array_equal(np.asarray(jstate), tstate.numpy())
    q = JRLX.queue_count(jpgm.n_edges, js.queues)
    for i, r in enumerate(residual_sets(jpgm.n_edges, seed=3)):
        key = jax.random.key(i)
        draw = np.array(jax.random.uniform(key, (q,)))
        jf, jnext = js.select(jpgm, jnp.asarray(r), EPS, key, jstate,
                              jnp.int32(0))
        tf, tnext = ts.select_with(tpgm, torch.from_numpy(r.copy()), EPS,
                                   torch.from_numpy(draw), tstate,
                                   torch.tensor(0))
        assert np.array_equal(np.asarray(jf), tf.numpy()), i
        if name == "rlxtree":
            assert np.array_equal(np.asarray(jnext), tnext.numpy())


@pytest.mark.parametrize("name,kwargs", RELAXED)
def test_batched_relaxed_matches_vmapped_reference(buckets, name, kwargs):
    jb, tb = buckets
    js, ts = JS.get_scheduler(name, **kwargs), TS.get_scheduler(name, **kwargs)
    jstate = jax.vmap(js.init)(jb.pgm)
    tstate = ts.init_batch(tb)
    if name == "rlxtree":
        assert np.array_equal(np.asarray(jstate), tstate.numpy())
        for b in range(tb.size):        # a row is the graph's own order
            assert torch.equal(tstate[b], ts.init(tb.graph(b)))
    q = JRLX.queue_count(jb.n_edges, js.queues)
    vselect = jax.vmap(lambda p, r, k, st, u: js.select(p, r, EPS, k, st, u))
    for i in range(3):
        r, u = batch_residuals(jb, 30 + i)
        keys = jax.random.split(jax.random.key(i), jb.size)
        draws = np.stack([np.array(jax.random.uniform(k, (q,)))
                          for k in keys])
        jf, _ = vselect(jb.pgm, jnp.asarray(r), keys, jstate,
                        jnp.asarray(u))
        tf, _ = ts.select_with(tb.pgm, torch.from_numpy(r), EPS,
                               torch.from_numpy(draws), tstate,
                               torch.from_numpy(u))
        assert np.array_equal(np.asarray(jf), tf.numpy()), i


@pytest.mark.parametrize("name", ["rlx", "rlxtree"])
def test_relaxed_runs_reach_reference_fixed_point(name):
    from repro.core import BPConfig as JConfig
    from repro.core import BPEngine as JEngine
    jpgm = JD.ising_grid(9, 2.0, seed=0)
    cfg = dict(scheduler=name, scheduler_kwargs={"p": 1 / 16}, eps=1e-5,
               max_rounds=3000)
    jres = JEngine(JConfig(**cfg)).run(jpgm, jax.random.key(0))
    tres = TEngine(TConfig(**cfg), device="cpu").run(
        bridge(jpgm), torch.Generator().manual_seed(7))
    assert bool(jres.converged) and bool(tres.converged)
    n = jpgm.n_real_vertices
    np.testing.assert_allclose(np.exp(np.asarray(jres.beliefs)[:n]),
                               np.exp(tres.beliefs[:n].numpy()), atol=1e-3)


@pytest.mark.parametrize("name,kwargs", RELAXED[1:3])
def test_relaxed_bucket_slots_bitwise_solo(buckets, name, kwargs):
    _, tb = buckets
    eng = TEngine(TConfig(scheduler=name, scheduler_kwargs=kwargs, eps=1e-3,
                          max_rounds=300), device="cpu")
    res = eng.run(tb, [slot_generator(5, i, "cpu") for i in range(tb.size)])
    for i in range(tb.size):
        solo = eng.run(tb.graph(i), slot_generator(5, i, "cpu"))
        for f in ("logm", "rounds", "updates", "max_residual",
                  "unconverged_history"):
            assert torch.equal(getattr(res, f)[i], getattr(solo, f)), (f, i)
        if name == "rlxtree":
            assert torch.equal(res.sched_state[i], solo.sched_state)
