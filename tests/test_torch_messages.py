"""``repro_torch.core.messages`` against ``repro.core.messages``.

Same graphs (bridged through numpy), same numpy-made messages, every
function of the module. Tolerance 1e-5 absolute on finite values: both
sides compute in float32 and differ only in their exp/log implementations
and reduction order. Entries at NEG_INF scale (sums of NEG_INF stand-ins on
invalid states) must sit at the same positions and agree to 1e-6
relative. Max-product is exact arithmetic (add, max, subtract) and must be
bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import messages as JM
from repro.pgm import datasets as JD
from repro_torch.core import messages as TM
from repro_torch.core.graph import PGM

TOL = 1e-5

GRAPHS = {
    "ising": lambda: JD.ising_grid(7, 2.0, seed=0),
    "chain": lambda: JD.chain_graph(300, seed=1),
    "protein": lambda: JD.protein_like_graph(40, seed=0),
}


def bridge(jpgm):
    """The reference graph's arrays, carried into the port."""
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices,
                          jpgm.n_real_edges, device="cpu")


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    """(reference PGM, port PGM, numpy messages, numpy frontier)."""
    jpgm = GRAPHS[request.param]()
    tpgm = bridge(jpgm)
    rng = np.random.default_rng(11)
    dmask = np.asarray(jpgm.state_mask)[np.asarray(jpgm.edge_dst)]
    x = np.where(dmask, rng.normal(0.0, 1.5, dmask.shape), -np.inf)
    x = x - np.logaddexp.reduce(x, axis=1, keepdims=True)
    logm = np.where(dmask, x, JM.NEG_INF).astype(np.float32)
    frontier = rng.random(dmask.shape[0]) < 0.5
    return jpgm, tpgm, logm, frontier


def close(j, t, tol=TOL):
    """Compare a reference output with a port output (see module doc)."""
    a = np.asarray(j)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.shape == b.shape
    big_a, big_b = a < -1e29, b < -1e29
    assert np.array_equal(big_a, big_b)
    np.testing.assert_allclose(b[big_b], a[big_a], rtol=1e-6)
    if (~big_a).any():
        assert np.abs(a[~big_a] - b[~big_b]).max() <= tol


def T(x):
    return torch.from_numpy(np.array(x))


def test_init_messages(case):
    jpgm, tpgm, _, _ = case
    close(JM.init_messages(jpgm), TM.init_messages(tpgm))


def test_masked_logsumexp(case):
    jpgm, _, logm, _ = case
    mask = np.asarray(jpgm.state_mask)[np.asarray(jpgm.edge_dst)]
    mask[::5] = False
    j = np.asarray(JM.masked_logsumexp(jnp.asarray(logm), jnp.asarray(mask),
                                       1))
    t = TM.masked_logsumexp(T(logm), T(mask), 1).numpy()
    some = mask.any(axis=1)
    close(j[some], torch.from_numpy(t[some]))
    # All-masked rows: the port stays finite (NEG_INF + log(1e-38) rounds
    # to NEG_INF). XLA:CPU flushes the subnormal 1e-38 to zero and gives
    # -inf there; every caller masks these rows afterwards.
    assert np.all(t[~some] == np.float32(JM.NEG_INF))
    assert np.all(np.isneginf(j[~some]))


def test_vertex_logprod_and_determinism(case):
    jpgm, tpgm, logm, _ = case
    first = TM.vertex_logprod(tpgm, T(logm))
    close(JM.vertex_logprod(jpgm, jnp.asarray(logm)), first)
    for _ in range(3):                      # fixed summation order
        assert torch.equal(TM.vertex_logprod(tpgm, T(logm)), first)


def test_edge_prelude(case):
    jpgm, tpgm, logm, _ = case
    close(JM.edge_prelude(jpgm, jnp.asarray(logm)),
          TM.edge_prelude(tpgm, T(logm)))


def test_propagate_normalize_residual(case):
    jpgm, tpgm, logm, _ = case
    pre = np.asarray(JM.edge_prelude(jpgm, jnp.asarray(logm)))
    jc = JM.propagate_ref(jpgm.log_psi_e, jnp.asarray(pre))
    tc = TM.propagate_ref(tpgm.log_psi_e, T(pre))
    close(jc, tc)
    dmask = np.asarray(jpgm.state_mask)[np.asarray(jpgm.edge_dst)]
    jn, jr = JM.normalize_and_residual(jc, jnp.asarray(logm),
                                       jnp.asarray(dmask), jpgm.edge_mask)
    tn, tr = TM.normalize_and_residual(T(np.asarray(jc)), T(logm), T(dmask),
                                       tpgm.edge_mask)
    close(jn, tn)
    close(jr, tr)
    close(JM.residuals(jpgm, jnp.asarray(logm), jn),
          TM.residuals(tpgm, T(logm), T(np.asarray(jn))))


def test_ref_update(case):
    jpgm, tpgm, logm, _ = case
    jc, jr = JM.ref_update(jpgm, jnp.asarray(logm))
    tc, tr = TM.ref_update(tpgm, T(logm))
    close(jc, tc)
    close(jr, tr)


def test_beliefs(case):
    jpgm, tpgm, logm, _ = case
    close(JM.beliefs(jpgm, jnp.asarray(logm)), TM.beliefs(tpgm, T(logm)))


def test_max_product_bitwise(case):
    jpgm, tpgm, logm, _ = case
    pre = np.asarray(JM.edge_prelude(jpgm, jnp.asarray(logm)))
    assert np.array_equal(
        np.asarray(JM.propagate_max(jpgm.log_psi_e, jnp.asarray(pre))),
        TM.propagate_max(tpgm.log_psi_e, T(pre)).numpy())
    jc, jr = JM.max_product_update(jpgm, jnp.asarray(logm))
    tc, tr = TM.max_product_update(tpgm, T(logm))
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(JM.map_assignment(jpgm, jnp.asarray(logm))),
                          TM.map_assignment(tpgm, T(logm)).numpy())


@pytest.mark.parametrize("damping", [0.0, 0.3])
def test_apply_frontier(case, damping):
    jpgm, tpgm, logm, frontier = case
    jc, _ = JM.ref_update(jpgm, jnp.asarray(logm))
    cand = np.asarray(jc)
    close(JM.apply_frontier(jnp.asarray(logm), jc, jnp.asarray(frontier),
                            damping),
          TM.apply_frontier(T(logm), T(cand), T(frontier), damping))


#: the zoo's generators (``repro.pgm.WORKLOADS``) at their defaults, and
#: one graph padded past its real edges (rows whose destination has no
#: valid state: the all-masked rows of ``test_masked_logsumexp``)
ZOO = ("ising", "chain", "protein", "ldpc", "stereo", "padded")


@pytest.fixture(scope="module", params=ZOO)
def zoo_case(request):
    """(reference PGM, port PGM, numpy candidates, numpy messages)."""
    from repro.core.graph import pad_pgm
    from repro.pgm import get_workload
    if request.param == "padded":
        g = JD.ising_grid(5, 2.0, seed=3)
        jpgm = pad_pgm(g, n_edges=g.n_edges + 16, n_vertices=g.n_vertices + 4,
                       n_states=3)
    else:
        jpgm = get_workload(request.param)(seed=2)
    rng = np.random.default_rng(5)
    dmask = np.asarray(jpgm.state_mask)[np.asarray(jpgm.edge_dst)]
    cand = rng.normal(0.0, 2.0, dmask.shape).astype(np.float32)
    x = np.where(dmask, rng.normal(0.0, 1.5, dmask.shape), -np.inf)
    with np.errstate(invalid="ignore"):
        x = x - np.logaddexp.reduce(x, axis=1, keepdims=True)
    logm = np.where(dmask, x, JM.NEG_INF).astype(np.float32)
    return jpgm, bridge(jpgm), cand, logm


def test_normalize_messages(zoo_case):
    """The masked LSE over valid destination states, then NEG_INF on the
    invalid ones; a row with no valid state is NEG_INF throughout in both
    packages (the reference's -inf LSE there is masked away)."""
    jpgm, tpgm, cand, _ = zoo_case
    j = JM.normalize_messages(jpgm, jnp.asarray(cand))
    t = TM.normalize_messages(tpgm, T(cand))
    close(j, t)
    dmask = np.asarray(jpgm.state_mask)[np.asarray(jpgm.edge_dst)]
    assert np.all(t.numpy()[~dmask] == np.float32(JM.NEG_INF))
    some = dmask.any(axis=1)
    lse = np.logaddexp.reduce(np.where(dmask, t.numpy(), -np.inf)[some],
                              axis=1)
    assert np.abs(lse).max() <= TOL


@pytest.mark.parametrize("semiring", ["sum", "max"])
def test_compute_candidates(zoo_case, semiring):
    jpgm, tpgm, _, logm = zoo_case
    jprop = JM.propagate_ref if semiring == "sum" else JM.propagate_max
    tprop = TM.propagate_ref if semiring == "sum" else TM.propagate_max
    j = JM.compute_candidates(jpgm, jnp.asarray(logm), jprop)
    t = TM.compute_candidates(tpgm, T(logm), tprop)
    close(j, t)
    if semiring == "sum":
        close(JM.compute_candidates(jpgm, jnp.asarray(logm)),
              TM.compute_candidates(tpgm, T(logm)))
