"""The port on the card: the CUDA kernel and the engine's determinism.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The file
imports torch and the port only (no JAX), so it runs on a machine that has
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

- The kernel matches its plain version on the card: sum-product within
  1e-4 absolute, max-product bitwise, identical NEG_INF entries.
- The engine on the card is deterministic: two runs and a chunked run give
  bitwise-equal results (the vertex sum uses no float atomics, and equals
  the CPU's bit for bit).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BPConfig, BPEngine
from repro_torch.core import messages as M
from repro_torch.kernels import triton_update as TT
from repro_torch.kernels.ref import fused_update_e_ref
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
