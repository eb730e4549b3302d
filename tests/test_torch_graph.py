"""The port's graphs against the reference's: builders, generators, the
numpy bridge and the registry's error texts.

Arrays must be *bitwise* equal (same dtype, same values): both packages
build on the host in numpy from the same seeded draws.
"""

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.registry import Registry as JRegistry
from repro.core.schedulers import SCHEDULERS as J_SCHEDULERS
from repro.kernels.ops import UPDATE_BACKENDS as J_BACKENDS
from repro.pgm import datasets as JD
from repro_torch.core import graph as TG
from repro_torch.core.registry import Registry as TRegistry
from repro_torch.core.schedulers import SCHEDULERS as T_SCHEDULERS
from repro_torch.kernels.ops import UPDATE_BACKENDS as T_BACKENDS
from repro_torch.pgm import datasets as TD

FIELDS = ("edge_src", "edge_dst", "edge_rev", "edge_mask", "log_psi_e",
          "log_psi_v", "state_mask", "n_states")

GENERATORS = {
    "ising_grid": (lambda: JD.ising_grid(6, 2.0, seed=3),
                   lambda: TD.ising_grid(6, 2.0, seed=3, device="cpu")),
    "ising_grid_fast": (lambda: JD.ising_grid_fast(12, 2.5, seed=1),
                        lambda: TD.ising_grid_fast(12, 2.5, seed=1,
                                                   device="cpu")),
    "small_ising": (lambda: JD.small_ising(5, 2.0, seed=2)[0],
                    lambda: TD.small_ising(5, 2.0, seed=2, device="cpu")[0]),
    "chain_graph": (lambda: JD.chain_graph(300, seed=4),
                    lambda: TD.chain_graph(300, seed=4, device="cpu")),
    "protein_like_graph": (lambda: JD.protein_like_graph(40, seed=0),
                           lambda: TD.protein_like_graph(40, seed=0,
                                                         device="cpu")),
}


def assert_same_graph(jpgm, tpgm):
    for f in FIELDS:
        a, b = np.asarray(getattr(jpgm, f)), getattr(tpgm, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert tpgm.n_real_vertices == jpgm.n_real_vertices
    assert tpgm.n_real_edges == jpgm.n_real_edges
    assert (tpgm.n_edges, tpgm.n_vertices, tpgm.n_states_max) == \
        (jpgm.n_edges, jpgm.n_vertices, jpgm.n_states_max)


def check_static_operands(pgm):
    """The incoming-edge table lists every real edge once, in its
    destination's row, ascending; dst_mask is state_mask[edge_dst]."""
    edge_dst = pgm.edge_dst.numpy()
    real = np.flatnonzero(pgm.edge_mask.numpy())
    table, mask = pgm.in_edges.numpy(), pgm.in_mask.numpy()
    listed = table[mask]
    assert np.array_equal(np.sort(listed), real)
    rows = np.nonzero(mask)[0]
    assert np.array_equal(edge_dst[listed], rows)
    for v in range(table.shape[0]):
        row = table[v][mask[v]]
        assert np.all(np.diff(row) > 0)
    assert pgm.dst_mask.dtype == torch.int8
    assert np.array_equal(pgm.dst_mask.numpy(),
                          pgm.state_mask.numpy()[edge_dst].astype(np.int8))
    assert np.array_equal(pgm.degree().numpy(),
                          np.bincount(edge_dst[real],
                                      minlength=pgm.n_vertices))


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bitwise_equal(name):
    make_j, make_t = GENERATORS[name]
    jpgm, tpgm = make_j(), make_t()
    assert_same_graph(jpgm, tpgm)
    check_static_operands(tpgm)


def test_small_ising_raw_arrays_equal():
    _, nj, ej, uj, pj = JD.small_ising(4, 2.0, seed=5)
    _, nt, et, ut, pt = TD.small_ising(4, 2.0, seed=5, device="cpu")
    assert nj == nt and np.array_equal(ej, et)
    assert all(np.array_equal(a, b) for a, b in zip(uj, ut))
    assert all(np.array_equal(a, b) for a, b in zip(pj, pt))


def test_build_pgm_mixed_states_and_state_pad():
    rng = np.random.default_rng(0)
    n = 9
    edges = np.array([(i, (i + 1) % n) for i in range(n)] + [(0, 4), (2, 7)])
    states = rng.integers(2, 6, size=n)
    unary = [rng.uniform(0.1, 1.0, size=s) for s in states]
    pairwise = [rng.uniform(0.1, 2.0, size=(states[i], states[j]))
                for i, j in edges]
    for pad in (None, 8):
        jpgm = JG.build_pgm(n, edges, unary, pairwise, state_pad_to=pad)
        tpgm = TG.build_pgm(n, edges, unary, pairwise, state_pad_to=pad,
                            device="cpu")
        assert_same_graph(jpgm, tpgm)
        check_static_operands(tpgm)


def test_build_pgm_uniform_bitwise_equal():
    rng = np.random.default_rng(7)
    n, s = 30, 3
    edges = np.stack([rng.integers(0, n, 50), rng.integers(0, n, 50)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    unary = rng.uniform(0.1, 1.0, size=(n, s))
    pairwise = rng.uniform(0.1, 2.0, size=(len(edges), s, s))
    jpgm = JG.build_pgm_uniform(n, edges, unary, pairwise)
    tpgm = TG.build_pgm_uniform(n, edges, unary, pairwise, device="cpu")
    assert_same_graph(jpgm, tpgm)
    check_static_operands(tpgm)


def test_from_numpy_round_trip():
    jpgm = JD.protein_like_graph(30, seed=2)
    arrays = {f: np.asarray(getattr(jpgm, f)) for f in FIELDS}
    arrays["edge_count"] = np.asarray(jpgm.edge_count)   # extra keys ignored
    tpgm = TG.PGM.from_numpy(arrays, jpgm.n_real_vertices, jpgm.n_real_edges,
                             device="cpu")
    assert_same_graph(jpgm, tpgm)
    check_static_operands(tpgm)
    back = tpgm.to_numpy()
    assert set(back) == set(FIELDS)
    again = TG.PGM.from_numpy(back, tpgm.n_real_vertices, tpgm.n_real_edges,
                              device="cpu")
    for f in ("in_edges", "in_mask", "dst_mask", *FIELDS):
        assert torch.equal(getattr(again, f), getattr(tpgm, f)), f


def test_constants_match():
    assert (TG.NEG_INF, TG.EDGE_PAD, TG.VERTEX_PAD) == \
        (JG.NEG_INF, JG.EDGE_PAD, JG.VERTEX_PAD)


def _error_text(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("cls_pair", [(JRegistry, TRegistry)])
def test_registry_error_texts_match(cls_pair):
    jcls, tcls = cls_pair
    jr, tr = jcls("widget", {"a": 1, "B": 2}), tcls("widget", {"a": 1, "B": 2})
    assert jr.names() == tr.names() == ["a", "b"]
    assert _error_text(lambda: jr.lookup("zz")) == \
        _error_text(lambda: tr.lookup("zz"))
    assert _error_text(lambda: jr.add("A", 3)) == \
        _error_text(lambda: tr.add("A", 3))
    assert jr.unknown("q") == tr.unknown("q")
    assert tr.lookup("b") == 2 and tr.add("a", 5, overwrite=True) == 5


def test_family_errors_match_reference():
    # Same family name, same uniform KeyError shape; the port's registries
    # list the names it has ported so far.
    _, jmsg = _error_text(lambda: J_SCHEDULERS.lookup("nope"))
    _, tmsg = _error_text(lambda: T_SCHEDULERS.lookup("nope"))
    assert jmsg.split(";")[0] == tmsg.split(";")[0] == \
        "\"unknown scheduler 'nope'"
    assert T_SCHEDULERS.names() == ["lbp", "rbp", "rnbp", "rs"]
    assert set(T_SCHEDULERS.names()) < set(J_SCHEDULERS.names())
    for name in ("pallas", "sharded"):
        kind, msg = _error_text(lambda: T_BACKENDS.lookup(name))
        assert kind is KeyError
        assert msg == repr(f"unknown update backend {name!r}; registered: "
                           "['maxprod', 'ref', 'triton']")
        assert name in J_BACKENDS
    assert T_BACKENDS.names() == ["maxprod", "ref", "triton"]


def test_resolve_device_refuses_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.resolve_device("cuda")
    assert TG.resolve_device("cpu") == torch.device("cpu")
