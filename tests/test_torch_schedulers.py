"""Frontier selection: the port's schedulers against the reference's.

Given identical residuals, LBP, RBP and RS must return bitwise-equal
frontier masks. RnBP draws random numbers, and torch's generators differ
from JAX's threefry, so it is compared through ``select_with``: the port
gets the very uniforms the reference draws from its key, and masks and
controller state must then be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as JS
from repro.pgm import datasets as JD
from repro_torch.core import schedulers as TS
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import frontier_size

EPS = 1e-3


def bridge(jpgm):
    """The reference graph's arrays, carried into the port."""
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices,
                          jpgm.n_real_edges, device="cpu")


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
    assert TS.list_schedulers() == ["lbp", "rbp", "rnbp", "rs"]
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        TS.get_scheduler("srbp")
    with pytest.raises(KeyError, match="unknown scheduler 'rlx'"):
        TS.get_scheduler("rlx")
    inst = TS.RBP(p=0.1)
    assert TS.get_scheduler(inst) is inst
    with pytest.raises(ValueError):
        TS.get_scheduler(inst, p=0.2)
