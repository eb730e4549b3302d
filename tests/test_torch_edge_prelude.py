"""The edge-prelude kernel's plain twin and wrapper, on the CPU.

``repro_torch.kernels.edge_prelude`` builds the kernel backends' ``pre``
by a walk over the vertices (``csrc/edge_prelude.cu``; the twin
``edge_prelude_ref`` is the same walk with index ops). Here:

- the twin, and the wrapper on CPU tensors, are bitwise
  ``messages.edge_prelude`` (compared as int32 bits, so -0.0 against 0.0
  counts) on messages taken from several rounds of real RnBP runs: a small
  Ising grid (S = 2), a small truncated-linear stereo frame (S = 16), an
  irregular graph with heterogeneous state counts and an in-degree above
  4, a graph padded by ``pad_pgm`` to a larger bucket's ceilings, and a
  ``BatchedPGM``'s ``folded()`` union; with planted -0.0 and NEG_INF rows;
- ``"pallas"`` and ``"triton"`` on the CPU route through the twin (one
  ``repro_torch::edge_prelude`` call an update, no launch counted) and
  give bitwise the update of ``messages.edge_prelude``'s ``pre``;
- the wrapper raises on a wrong dtype, shape or device type and on a
  non-contiguous operand; the launch plan follows S and alignment;
- the op is counted as one fused call, ``edge_prelude_cost``, and on fake
  tensors gives the shape with nothing launched.
"""

import dataclasses
import pathlib
import sys
import types

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.core import BatchedPGM
from repro_torch.core import messages as M
from repro_torch.core.graph import NEG_INF, pad_pgm
from repro_torch.kernels import edge_prelude as EP
from repro_torch.kernels import ops as TO
from repro_torch.kernels.ref import fused_update_e_ref
from repro_torch.pgm import datasets as TD
from repro_torch.roofline import kernel_model as TK
from repro_torch.roofline.op_cost import OpCounter, trace_cost

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the script lives at the repo root)

CPU = torch.device("cpu")


def operands(pgm, logm):
    return (logm, pgm.log_psi_v, pgm.state_mask, pgm.in_edges, pgm.in_mask,
            pgm.edge_src, pgm.edge_rev, pgm.edge_mask)


def run_messages(graph, rounds=(0, 3, 9)):
    """``chip_smoke.rnbp_messages`` (messages of an RnBP run after each
    count of ``rounds``, a bucket's as its union's rows), plus a copy of
    the last with planted -0.0 entries and whole NEG_INF rows."""
    out = cs.rnbp_messages(graph, CPU, rounds)
    planted = out[-1].clone()
    planted[::3, 0] = -0.0
    planted[1::7] = NEG_INF
    return out + [planted]


def stereo(seed=0):
    return TD.stereo_mrf(6, 8, 16, seed=seed, device="cpu").pgm


def irregular():
    g = TD.protein_like_graph(40, seed=1, device="cpu")
    assert g.in_edges.shape[1] > 4
    assert len(set(g.n_states[:g.n_real_vertices].tolist())) > 1
    return g


GRAPHS = {
    "ising": lambda: TD.ising_grid_fast(7, 2.0, seed=0, device="cpu"),
    "stereo": stereo,
    "irregular": irregular,
    "padded": lambda: pad_pgm(TD.ising_grid_fast(5, 2.0, seed=3,
                                                 device="cpu"),
                              n_edges=384, n_vertices=48, n_states=3,
                              n_real_edges=300, n_real_vertices=40),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_twin_is_bitwise_the_torch_prelude(name):
    g = GRAPHS[name]()
    if name == "stereo":
        assert g.n_states_max == 16
    for logm in run_messages(g):
        want = M.edge_prelude(g, logm)
        assert cs.bitwise(EP.edge_prelude_ref(*operands(g, logm)), want)
        assert cs.bitwise(EP.edge_prelude(g, logm), want)


def test_twin_is_bitwise_on_a_bucket_union():
    batch = BatchedPGM.from_pgms([
        TD.ising_grid_fast(5, 2.5, seed=1, device="cpu"), stereo(2),
        TD.protein_like_graph(12, seed=0, device="cpu")])
    union = batch.folded()
    for logm in run_messages(batch):
        want = M.edge_prelude(union, logm)
        assert cs.bitwise(EP.edge_prelude_ref(*operands(union, logm)), want)
        assert cs.bitwise(EP.edge_prelude(union, logm), want)


@pytest.mark.parametrize("backend", ["pallas", "triton"])
def test_kernel_backends_route_through_the_twin_on_the_cpu(backend):
    g = stereo(1)
    logm = run_messages(g, rounds=(4,))[0]
    before = dict(EP.LAUNCHES)
    with OpCounter() as c:
        cand, resid = TO.get_update_fn(backend)(g, logm)
    assert c.calls["repro_torch.edge_prelude"] == 1
    assert EP.LAUNCHES == before
    want = fused_update_e_ref(g.log_psi_e, M.edge_prelude(g, logm), logm,
                              g.dst_mask)
    if backend == "triton":
        assert cs.bitwise(cand, want[0]) and cs.bitwise(resid, want[1])
    else:
        assert torch.equal(cand == NEG_INF, want[0] == NEG_INF)
        assert float((cand - want[0]).abs().max()) <= 1e-5


def test_bucket_fold_routes_through_the_twin():
    batch = BatchedPGM.from_pgms([stereo(3), stereo(4)])
    logm = M.init_messages(batch.folded()).reshape(
        batch.size, batch.n_edges, -1)
    with OpCounter() as c:
        TO.pallas_update_batch(batch, logm)
        TO.triton_update_batch(batch, logm)
    assert c.calls["repro_torch.edge_prelude"] == 2


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g = TD.ising_grid_fast(4, 2.0, seed=0, device="cpu")
    logm = M.init_messages(g)
    with pytest.raises(TypeError, match="logm"):
        EP.edge_prelude(g, logm.double())
    with pytest.raises(ValueError, match="contiguous"):
        EP.edge_prelude(g, logm.t().contiguous().t())
    with pytest.raises(ValueError, match="edge_src must be"):
        EP.edge_prelude(g, logm[:-1])
    with pytest.raises(TypeError, match="in_edges"):
        EP.edge_prelude(dataclasses.replace(g, in_edges=g.in_edges.long()),
                        logm)
    meta = types.SimpleNamespace(**{
        k: getattr(g, k).to("meta") for k in (
            "log_psi_v", "state_mask", "in_edges", "in_mask", "edge_src",
            "edge_rev", "edge_mask")})
    with pytest.raises(ValueError, match="cpu or cuda"):
        EP.edge_prelude(meta, logm.to("meta"))
    with pytest.raises(ValueError, match="states"):
        EP.plan_prelude(0)


@pytest.mark.parametrize("s,aligned,want", [
    (16, 16, (4, 4)), (2, 16, (2, 1)), (81, 16, (1, 32)), (3, 16, (1, 4)),
    (1, 16, (1, 1)), (128, 16, (4, 32)), (16, 8, (2, 8)), (16, 4, (1, 16)),
    (6, 16, (2, 4)), (51, 16, (1, 32))])
def test_launch_plan_follows_states_and_alignment(s, aligned, want):
    assert EP.plan_prelude(s, aligned) == want


def test_op_is_counted_by_its_contract_and_fakes_launch_nothing():
    g = stereo(5)
    logm = M.init_messages(g)
    (e, s), (v, d) = logm.shape, g.in_edges.shape
    model = TK.edge_prelude_cost(e, v, s, d)
    with OpCounter() as c:
        EP.edge_prelude(g, logm)
    assert c.cost == model and c.calls == {"repro_torch.edge_prelude": 1}
    # every operand but edge_src, which only padded edges read
    assert model.bytes == sum(t.numel() * t.element_size()
                              for t in operands(g, logm)
                              if t is not g.edge_src) + 4 * e * s
    specs = [(tuple(t.shape), t.dtype) for t in operands(g, logm)]
    before = dict(EP.LAUNCHES)
    got = trace_cost(lambda *o: torch.ops.repro_torch.edge_prelude(*o),
                     *specs, device="cuda")
    assert got == model and EP.LAUNCHES == before and EP._lib is None


def test_cuda_tensors_build_the_kernel_or_raise(monkeypatch):
    """On CUDA tensors the op builds its kernel or raises: with no CUDA
    toolkit it raises, nothing falls back to the twin and no launch is
    counted. Fake CUDA tensors get the shape only."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; test_torch_cuda.py covers it")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(EP, "_lib", None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build._BUILD_DIR / "absent.so")
    before = dict(EP.LAUNCHES)
    e, v, s, d = 8, 5, 3, 2
    with FakeTensorMode():
        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="cuda")
        graph = types.SimpleNamespace(
            log_psi_v=empty(v, s), state_mask=empty(v, s, dtype=torch.bool),
            in_edges=empty(v, d, dtype=torch.int32),
            in_mask=empty(v, d, dtype=torch.bool),
            edge_src=empty(e, dtype=torch.int32),
            edge_rev=empty(e, dtype=torch.int32),
            edge_mask=empty(e, dtype=torch.bool))
        logm = empty(e, s)
        with pytest.raises(RuntimeError, match="nvcc"):
            EP._launch(*operands(graph, logm))
        pre = EP.edge_prelude(graph, logm)
    assert (tuple(pre.shape), pre.device.type) == ((e, s), "cuda")
    assert EP._lib is None and EP.LAUNCHES == before
