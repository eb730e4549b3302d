"""The host-serial SRBP baseline, the exact oracles and the deprecated
wrappers: the port's ``core/serial``, ``core/exact`` and ``core/runner``
against the reference's.

- SRBP (``BPEngine(BPConfig(scheduler="srbp"))``) runs the reference's
  numpy on the graph's host arrays, so under a ``max_updates`` bound (and
  to convergence) its update count, beliefs, residual and verdict are the
  reference's bit for bit; the port's graph is read to the host once.
- The brute-force and variable-elimination oracles and ``kl_divergence``
  are numpy copies: bitwise the reference's.
- ``run_bp``/``run_bp_batch``/``run_bp_many`` warn as the reference's do
  and return bitwise what the engine returns.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import exact as JX
from repro.core import runner as JRun
from repro.core.serial import srbp_run as j_srbp_run
from repro.pgm import datasets as JD
from repro_torch.core import (BatchedPGM, BPConfig, BPEngine, exact as TX,
                              serial as TSer)
from repro_torch.core import runner as TRun
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers import LBP, RnBP
from repro_torch.pgm import datasets as TD

CPU = "cpu"


def bridge(jpgm):
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device=CPU,
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


GRAPHS = {
    "ising5": lambda: JD.ising_grid(5, 2.0, seed=0),
    "chain12": lambda: JD.chain_graph(12, seed=1),
    "protein16": lambda: JD.protein_like_graph(16, seed=0),
}


@pytest.mark.parametrize("max_updates", [1, 37, 10_000_000])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_srbp_matches_reference_bitwise(name, max_updates):
    jpgm = GRAPHS[name]()
    want = j_srbp_run(jpgm, eps=1e-3, max_updates=max_updates,
                      time_limit_s=600.0)
    eng = BPEngine(BPConfig(scheduler="srbp", eps=1e-3, scheduler_kwargs={
        "max_updates": max_updates, "time_limit_s": 600.0}), device=CPU)
    got = eng.run(bridge(jpgm))
    assert isinstance(got, TSer.SRBPResult)
    assert got.updates == want.updates
    assert got.converged == want.converged
    assert got.max_residual == want.max_residual
    assert got.beliefs.dtype == want.beliefs.dtype == np.float64
    np.testing.assert_array_equal(got.beliefs, want.beliefs)
    if max_updates < 10_000:
        assert got.updates == max_updates and not got.converged
    else:
        assert got.converged


def test_srbp_entry_points():
    pgm = TD.ising_grid(4, 2.0, seed=0, device=CPU)
    eng = BPEngine(BPConfig(scheduler="srbp"), device=CPU)
    assert eng.is_serial and eng.scheduler is None
    with pytest.raises(NotImplementedError, match="host-serial"):
        eng.init(pgm, torch.Generator())
    with pytest.raises(NotImplementedError, match="host-serial"):
        eng.step(None)
    with pytest.warns(DeprecationWarning, match="run_srbp is deprecated"):
        old = TSer.run_srbp(pgm, max_updates=50)
    new = eng.run(pgm)
    assert old.updates == 50 and new.converged
    with pytest.raises(TypeError, match="PGM"):
        eng.run(np.zeros(3))


def tiny_model(n, rng, states):
    """A random loopy model: a ring plus a chord, positive tables."""
    edges = np.array([(i, (i + 1) % n) for i in range(n)] + [(0, n // 2)])
    unary = [rng.uniform(0.2, 2.0, states[v]) for v in range(n)]
    pairwise = [rng.uniform(0.2, 2.0, (states[i], states[j]))
                for i, j in edges]
    return edges, unary, pairwise


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_oracles_are_the_references(seed):
    rng = np.random.default_rng(seed)
    n = 6
    states = [2 + (v % 3) for v in range(n)]
    edges, unary, pairwise = tiny_model(n, rng, states)
    for fn in ("brute_force_marginals", "ve_marginals"):
        got = getattr(TX, fn)(n, edges, unary, pairwise)
        want = getattr(JX, fn)(n, edges, unary, pairwise)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    bf = TX.brute_force_marginals(n, edges, unary, pairwise)
    ve = TX.ve_marginals(n, edges, unary, pairwise)
    for a, b in zip(bf, ve):
        np.testing.assert_allclose(a, b, atol=1e-12)
        assert TX.kl_divergence(a, b) == JX.kl_divergence(a, b)
    p, q = rng.random(5), rng.random(5)
    assert TX.kl_divergence(p, q) == JX.kl_divergence(p, q) > 0.0


def test_run_bp_matches_reference_and_the_engine():
    jpgm = JD.ising_grid(6, 2.0, seed=3)
    pgm = bridge(jpgm)
    with pytest.warns(DeprecationWarning) as jw:
        want = JRun.run_bp(jpgm, "lbp", jax.random.key(0), eps=1e-4)
    with pytest.warns(DeprecationWarning) as tw:
        got = TRun.run_bp(pgm, LBP(), torch.Generator(), eps=1e-4)
    assert str(tw[0].message).replace("repro_torch", "repro") == \
        str(jw[0].message)
    assert int(got.rounds) == int(want.rounds)
    np.testing.assert_allclose(np.exp(got.beliefs.numpy()),
                               np.exp(np.asarray(want.beliefs)), atol=1e-4)
    eng = BPEngine(BPConfig(scheduler=LBP(), eps=1e-4), device=CPU)
    same = eng.run(pgm, torch.Generator())
    assert torch.equal(got.logm, same.logm)
    # the old state backdoor: resume from the engine's own messages
    state = eng.init(pgm, torch.Generator())
    for _ in range(3):
        state = eng.step(state, chunk_rounds=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = TRun.run_bp(pgm, "lbp", torch.Generator(), eps=1e-4,
                          _init_logm=state.logm)
    assert bool(res.converged)


def test_batch_wrappers_warn_and_equal_the_engine():
    pgms = [TD.ising_grid(5, 1.8, seed=s, device=CPU) for s in range(3)] + [
        TD.chain_graph(20, seed=1, device=CPU)]
    sched = RnBP(low_p=0.4, high_p=0.9)
    eng = BPEngine(BPConfig(scheduler=sched, history=False), device=CPU)
    with pytest.warns(DeprecationWarning, match="run_bp_many is deprecated"):
        many = TRun.run_bp_many(pgms, sched, 5)
    for a, b in zip(many, eng.run_many(pgms, 5)):
        assert torch.equal(a.logm, b.logm) and int(a.rounds) == int(b.rounds)
    batch = BatchedPGM.from_pgms(pgms[:3])
    with pytest.warns(DeprecationWarning, match="run_bp_batch is deprecated"):
        res = TRun.run_bp_batch(batch, sched, 5)
    want = eng.run(batch, 5)
    assert torch.equal(res.logm, want.logm)
    assert torch.equal(res.rounds, want.rounds)
    with pytest.raises(TypeError, match="unknown arguments"):
        TRun.run_bp_many(pgms, sched, 5, nope=1)
    assert TRun.run_bp_many([], sched, 5) == []
