"""The port's graphs against the reference's: builders, generators, the
numpy bridge and the registry's error texts.

Arrays must be *bitwise* equal (same dtype, same values): both packages
build on the host in numpy from the same seeded draws.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import graph as JG
from repro.core.registry import Registry as JRegistry
from repro.core.schedulers import SCHEDULERS as J_SCHEDULERS
from repro.kernels.ops import BATCH_UPDATE_BACKENDS as J_BATCH_BACKENDS
from repro.kernels.ops import UPDATE_BACKENDS as J_BACKENDS
from repro.pgm import datasets as JD
from repro_torch.core import graph as TG
from repro_torch.core.registry import Registry as TRegistry
from repro_torch.core.schedulers import SCHEDULERS as T_SCHEDULERS
from repro_torch.kernels.ops import BATCH_BACKEND_NAMES as T_BATCH_NAMES
from repro_torch.kernels.ops import get_batch_update_fn as t_batch_update_fn
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
    "loop_graph": (lambda: JD.loop_graph(24, seed=5),
                   lambda: TD.loop_graph(24, seed=5, device="cpu")),
    "ldpc_graph": (lambda: JD.ldpc_graph(3, n=24, dv=2, dc=4),
                   lambda: TD.ldpc_graph(3, n=24, dv=2, dc=4, device="cpu")),
    "stereo_graph": (lambda: JD.stereo_graph(2, height=6, width=8, n_disp=5),
                     lambda: TD.stereo_graph(2, height=6, width=8, n_disp=5,
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
    assert T_SCHEDULERS.names() == J_SCHEDULERS.names() == [
        "lbp", "rbp", "rlx", "rlxtree", "rnbp", "rs"]
    assert tmsg == jmsg         # every scheduler is ported: the same text
    assert T_BACKENDS.names() == J_BACKENDS.names() == [
        "maxprod", "pallas", "ref", "sharded", "triton"]
    kind, msg = _error_text(lambda: T_BACKENDS.lookup("nope"))
    assert kind is KeyError     # every backend is ported: the same text
    assert (kind, msg) == _error_text(lambda: J_BACKENDS.lookup("nope"))
    assert list(T_BATCH_NAMES) == J_BATCH_BACKENDS.names() == \
        ["pallas", "triton"]
    assert _error_text(lambda: t_batch_update_fn("ref")) == \
        _error_text(lambda: J_BATCH_BACKENDS.lookup("ref"))


def test_resolve_device_refuses_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.resolve_device("cuda")
    assert TG.resolve_device("cpu") == torch.device("cpu")


def test_zoo_instances_match_reference():
    """The LDPC and stereo instances carry the reference's scene, code and
    potentials, and score a labeling the same way."""
    jl = JD.ldpc_code(48, dv=3, dc=6, snr_db=1.5, seed=4)
    tl = TD.ldpc_code(48, dv=3, dc=6, snr_db=1.5, seed=4, device="cpu")
    assert_same_graph(jl.pgm, tl.pgm)
    assert tl.checks == jl.checks and tl.n_vertices == jl.n_vertices
    assert (tl.sigma, tl.snr_db, tl.uncoded_errors) == \
        (jl.sigma, jl.snr_db, jl.uncoded_errors)
    for f in ("y", "llr", "edges"):
        assert np.array_equal(getattr(tl, f), getattr(jl, f)), f
    assert all(np.array_equal(a, b) for a, b in zip(tl.unary, jl.unary))
    assert all(np.array_equal(a, b) for a, b in zip(tl.pairwise, jl.pairwise))
    bits = np.random.default_rng(0).integers(0, 2, 48)
    assert tl.coded_errors(bits) == jl.coded_errors(bits)
    js = JD.stereo_mrf(9, 12, 6, seed=3)
    ts = TD.stereo_mrf(9, 12, 6, seed=3, device="cpu")
    assert_same_graph(js.pgm, ts.pgm)
    for f in ("truth", "obs", "edges", "unary", "pairwise"):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    labels = np.random.default_rng(1).integers(0, 6, 9 * 12)
    assert ts.energy(labels) == js.energy(labels)
    assert ts.accuracy(labels) == js.accuracy(labels)


def test_zoo_stream_matches_reference():
    jstream = list(JD.zoo_stream(18, seed=1))
    tstream = list(TD.zoo_stream(18, seed=1, device="cpu"))
    assert [k for k, _ in tstream] == [k for k, _ in jstream]
    for (_, jp), (_, tp) in zip(jstream, tstream):
        assert_same_graph(jp, tp)
        assert (tp.edge_count, tp.vertex_count) == \
            (int(jp.edge_count), int(jp.vertex_count))
    assert TD.list_workloads() == JD.list_workloads()
    sub = [(k, slo) for k, _, slo in TD.zoo_stream(
        6, kinds=["chain", "ldpc"], slos={"chain": 0.5}, device="cpu")]
    assert sub == [(k, slo) for k, _, slo in JD.zoo_stream(
        6, kinds=["chain", "ldpc"], slos={"chain": 0.5})]
    assert _error_text(lambda: TD.get_workload("nope")) == \
        _error_text(lambda: JD.get_workload("nope"))


@pytest.mark.parametrize("grow", [(0, 0, 0), (256, 16, 3), (128, 8, 0)])
def test_pad_pgm_bitwise_equal(grow):
    de, dv, ds = grow
    jpgm = JD.protein_like_graph(20, seed=4)
    tpgm = TG.PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices,
                             jpgm.n_real_edges, device="cpu")
    kw = dict(n_edges=jpgm.n_edges + de, n_vertices=jpgm.n_vertices + dv,
              n_states=jpgm.n_states_max + ds)
    jarr = JG.pad_pgm_arrays(jpgm, **kw)
    tarr = TG.pad_pgm_arrays(tpgm, **kw)
    assert set(tarr) == set(jarr)
    for k in jarr:
        assert tarr[k].dtype == jarr[k].dtype and \
            np.array_equal(tarr[k], jarr[k]), k
    ceil = dict(n_real_edges=4096, n_real_vertices=512)
    jpad, tpad = JG.pad_pgm(jpgm, **kw, **ceil), TG.pad_pgm(tpgm, **kw, **ceil)
    assert_same_graph(jpad, tpad)
    check_static_operands(tpad)
    assert (tpad.edge_count, tpad.vertex_count) == \
        (int(jpad.edge_count), int(jpad.vertex_count)) == \
        (jpgm.n_real_edges, jpgm.n_real_vertices)
    if de:        # padded edges are not in the incoming-edge table
        assert torch.equal(tpad.in_edges[tpad.in_mask].sort().values,
                           tpgm.in_edges[tpgm.in_mask].sort().values)
    with pytest.raises(ValueError, match="cannot shrink"):
        TG.pad_pgm(tpgm, n_edges=1, n_vertices=1, n_states=1)
