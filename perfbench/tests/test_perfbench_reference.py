"""The yardstick's own arithmetic: byte counts, generators, reference."""

import itertools

import numpy as np
import pytest
import torch

from perfbench import roofline
from perfbench.inputs import ising_grid, stereo
from perfbench.reference import pairwise_bp

ISING = dict(n=3, coupling=2.5, unary_low=1e-3, unary_high=1.0,
             lambda_low=-0.5, lambda_high=0.5)
STEREO = dict(height=6, width=8, n_disp=4, noise=0.6, outlier_frac=0.05,
              lam_data=1.0, trunc_data=2.0, lam_smooth=0.55, trunc_smooth=2.0)


@pytest.mark.parametrize("e, s, tables, want", [
    # 3S + 1 floats and S mask bytes a directed edge, S^2 floats a table,
    # by hand: Ising's table per undirected edge, four stereo frames' one
    (3_996_032, 2, 1_998_016, 3_996_032 * ((6 + 1) * 4 + 2) + 1_998_016 * 16),
    (1_764_352, 16, 4, 1_764_352 * ((48 + 1) * 4 + 16) + 4 * 256 * 4),
])
def test_update_bytes_by_hand(e, s, tables, want):
    assert roofline.update_bytes(e, s, tables) == want
    assert want == {2: 151_849_216, 16: 374_046_720}[s]


def test_inputs_count_their_distinct_tables():
    """A stereo frame's edges share one table (a broadcast view); an
    Ising grid has one a undirected edge."""
    frame = stereo.make(dict(STEREO, height=288, width=384, n_disp=16), 0)
    assert len(frame["edges"]) == 220_512
    assert roofline.distinct_tables(frame["pairwise"]) == 1
    assert roofline.input_bytes(frame) == 441_024 * 212 + 1024
    grid = ising_grid.make(dict(ISING, n=5), 0)
    assert roofline.distinct_tables(grid["pairwise"]) == 40
    assert roofline.input_bytes(grid) == 80 * 30 + 40 * 16


def test_rounds_come_from_the_answers():
    """A call's rounds are its graphs' most, whatever the launch counters
    say; a kernel's share reads the rounds' work over its device time."""
    calls = [dict(rounds=[40, 45], update_bytes=1000, launches={"k": 99}),
             dict(rounds=[50], update_bytes=2000, launches={})]
    assert roofline.rounds_run(calls) == 95
    assert roofline.round_work(calls) == 45 * 1000 + 50 * 2000
    trace = dict(calls=calls, kernels={"edge_t_kernel": [3, 1e-6],
                                       "gather_kernel": [9, 5.0]})
    ctx = dict(trace=trace, peaks={"hbm_bytes_per_s": 1e12})
    share = roofline.kernel_share(ctx, r"\bedge_t_kernel\b")
    assert share == pytest.approx(100 * 145_000 / 1e12 / 1e-6)
    assert roofline.kernel_share(ctx, r"\bedge_thread_kernel\b") is None
    assert roofline.kernel_share(dict(ctx, peaks=None), "edge") is None


def test_card_peaks_by_name():
    assert roofline.card_peaks("NVIDIA H100 80GB HBM3")[
        "hbm_bytes_per_s"] == 3.35e12
    assert roofline.card_peaks("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2e12
    assert roofline.card_peaks("cpu") is None


def brute_force(inputs):
    """Exact log-marginals by enumerating every joint state."""
    v, edges = inputs["n_vertices"], inputs["edges"]
    lu, lp = np.log(inputs["unary"]), np.log(np.asarray(inputs["pairwise"]))
    s = lu.shape[1]
    joint = np.array(list(itertools.product(range(s), repeat=v)))
    score = lu[np.arange(v), joint].sum(axis=1)
    score += lp[np.arange(len(edges)), joint[:, edges[:, 0]],
                joint[:, edges[:, 1]]].sum(axis=1)
    p = np.exp(score - score.max())
    p /= p.sum()
    return np.stack([np.bincount(joint[:, i], weights=p, minlength=s)
                     for i in range(v)])


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7])
def test_reference_is_exact_on_the_grids_spanning_tree(seed):
    """BP is exact on trees: on the 3 x 3 Ising grid's comb (every
    horizontal edge of the top row and every vertical edge) the
    reference's marginals are the brute-force ones."""
    full = ising_grid.make(ISING, seed)
    keep = [k for k, (a, b) in enumerate(full["edges"])
            if b - a == 3 or a < 3]
    tree = dict(full, edges=full["edges"][keep],
                pairwise=full["pairwise"][keep])
    g = pairwise_bp.Graph(tree, "cpu", torch.float64)
    ans = pairwise_bp.solve(g, eps=1e-12, max_rounds=200, low_p=1.0,
                            high_p=1.0, generator=torch.Generator())
    assert ans["converged"]
    np.testing.assert_allclose(ans["beliefs"].exp().numpy(),
                               brute_force(tree), atol=1e-10)


def test_reference_on_the_loopy_grid_is_a_fixed_point_near_exact():
    """On the 3 x 3 grid itself (four loops) BP is not exact: the
    reference reaches a fixed point that the judge accepts, and its
    marginals lie near the brute-force ones."""
    inputs = ising_grid.make(ISING, 3)
    g = pairwise_bp.Graph(inputs, "cpu", torch.float64)
    ans = pairwise_bp.solve(g, eps=1e-9, max_rounds=2000, low_p=0.4,
                            high_p=0.9, generator=torch.Generator())
    assert ans["converged"]
    got = pairwise_bp.judge(g, ans["logm"], ans["beliefs"])
    assert got["fixed_point_resid"] < 1e-9 and got["belief_gap"] < 1e-12
    assert np.abs(ans["beliefs"].exp().numpy()
                  - brute_force(inputs)).max() < 0.1


def test_judge_reads_a_broken_answer():
    inputs = stereo.make(STEREO, 4)
    g = pairwise_bp.Graph(inputs, "cpu", torch.float64)
    ans = pairwise_bp.solve(g, eps=1e-6, max_rounds=500, low_p=0.4,
                            high_p=0.9, generator=torch.Generator())
    good = pairwise_bp.judge(g, ans["logm"], ans["beliefs"])
    assert good["fixed_point_resid"] < 1e-6 and good["belief_gap"] < 1e-12
    uniform = torch.full_like(ans["logm"], -np.log(STEREO["n_disp"]))
    assert pairwise_bp.judge(g, uniform, ans["beliefs"])[
        "fixed_point_resid"] > 0.1
    bent = ans["beliefs"].clone()
    bent[5] = torch.log_softmax(bent[5] + torch.arange(4.0), dim=0)
    assert pairwise_bp.judge(g, ans["logm"], bent)["belief_gap"] > 0.01


@pytest.mark.parametrize("make, params, port", [
    (ising_grid.make, dict(ISING, n=7), "ising"),
    (stereo.make, STEREO, "stereo"),
])
def test_frozen_generators_match_the_ports(make, params, port):
    """The frozen copies draw exactly the port's arrays (the port is
    imported here only, never by the yardstick)."""
    from repro_torch.pgm import datasets
    seed = 2 ** 31 + 11
    ours = make(params, seed)
    if port == "ising":
        theirs = datasets.ising_grid_fast(params["n"], params["coupling"],
                                          seed=seed, device="cpu")
    else:
        sp = dict(params)
        inst = datasets.stereo_mrf(sp.pop("height"), sp.pop("width"),
                                   sp.pop("n_disp"), seed=seed, device="cpu",
                                   **sp)
        np.testing.assert_array_equal(ours["unary"], inst.unary)
        np.testing.assert_array_equal(ours["pairwise"], inst.pairwise)
        theirs = inst.pgm
    from repro_torch.core import build_pgm_uniform
    rebuilt = build_pgm_uniform(ours["n_vertices"], ours["edges"],
                                ours["unary"], ours["pairwise"], device="cpu")
    for field in ("edge_src", "edge_dst", "log_psi_e", "log_psi_v"):
        assert torch.equal(getattr(rebuilt, field), getattr(theirs, field))


@pytest.mark.parametrize("sym", range(1, ising_grid.N_SYMMETRIES))
def test_catalog_symmetries_keep_the_graph(sym):
    """A catalog graph under any of the 16 symmetries is the same graph
    laid out anew: synchronous BP takes as many rounds and its marginals
    are the base graph's, moved with its vertices (states swapped with
    the state swap)."""
    params = dict(ISING, n=5, coupling=2.0, catalog=[4, 9])
    base = ising_grid.make(dict(params, catalog=None), 9)
    moved = ising_grid.make(params, sym, slot=1)
    assert np.array_equal(moved["edges"], base["edges"])
    out = []
    for inputs in (base, moved):
        g = pairwise_bp.Graph(inputs, "cpu", torch.float64)
        out.append(pairwise_bp.solve(g, eps=1e-9, max_rounds=500, low_p=1.0,
                                     high_p=1.0, generator=torch.Generator()))
    assert out[0]["converged"] and out[0]["rounds"] == out[1]["rounds"]
    old = np.rot90(np.arange(25).reshape(5, 5), sym % 4)
    old = (old.T if (sym // 4) % 2 else old).ravel()
    want = out[0]["beliefs"].numpy()[old]
    if sym // 8:
        want = want[:, ::-1]
    np.testing.assert_allclose(out[1]["beliefs"].numpy(), want, atol=1e-9)


@pytest.mark.parametrize("sym", range(1, stereo.N_SYMMETRIES))
def test_stereo_symmetries_keep_the_frame(sym):
    params = dict(STEREO, catalog=[7])
    base = stereo.make(dict(params, catalog=None), 7)
    moved = stereo.make(params, sym)
    out = []
    for inputs in (base, moved):
        g = pairwise_bp.Graph(inputs, "cpu", torch.float64)
        out.append(pairwise_bp.solve(g, eps=1e-9, max_rounds=500, low_p=1.0,
                                     high_p=1.0, generator=torch.Generator()))
    assert out[0]["converged"] and out[0]["rounds"] == out[1]["rounds"]
    old = np.arange(48).reshape(6, 8)
    old = old[::-1] if sym & 1 else old
    old = (old[:, ::-1] if sym & 2 else old).ravel()
    want = out[0]["beliefs"].numpy()[old]
    want = want[:, ::-1] if sym & 4 else want
    np.testing.assert_allclose(out[1]["beliefs"].numpy(), want, atol=1e-9)
