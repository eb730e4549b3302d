"""The ``"pallas"`` path and the batched backends against the reference.

On CPU tensors ``repro_torch.kernels.message_update.fused_update_t`` runs
its plain version; it must match the reference's Pallas kernel (interpret
mode, as the reference's own tests run it on CPU) and its plain oracle
within 1e-4 absolute (float32, different exp/log implementations). The
single-graph ``pallas_update`` and the bucket backends
``pallas_update_batch``/``triton_update_batch`` are held against their JAX
twins on the same graphs and messages: sum-product within 1e-4,
max-product bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import BatchedPGM as JBatch
from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.kernels import message_update as JMU
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.pgm import datasets as JD
from repro_torch.core import BatchedPGM as TBatch
from repro_torch.core import BPConfig as TConfig
from repro_torch.core import BPEngine as TEngine
from repro_torch.core import messages as TM
from repro_torch.core.graph import PGM
from repro_torch.kernels import message_update as TMU
from repro_torch.kernels import ops as TO
from repro_torch.kernels.ref import fused_update_t_ref

NEG_INF = -1.0e30
SUM_TOL = 1e-4


def bridge(jpgm):
    """The reference graph's arrays and counts, carried into the port."""
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device="cpu",
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


def operands_t(e, s, seed):
    """(S, E)-layout numpy inputs with NEG_INF invalid states, all-masked
    edges (every 5th) and edges with no valid source state (every 7th)."""
    rng = np.random.default_rng(seed)
    logpsi_t = rng.normal(0.0, 1.0, (s, s, e)).astype(np.float32)
    valid_dst = rng.random((s, e)) < 0.7
    valid_dst[:, ::5] = False
    valid_src = rng.random((s, e)) < 0.7
    valid_src[:, ::7] = False
    pre_t = np.where(valid_src, rng.normal(0.0, 2.0, (s, e)),
                     NEG_INF).astype(np.float32)
    logm_t = np.where(valid_dst, rng.normal(-2.0, 1.0, (s, e)),
                      NEG_INF).astype(np.float32)
    return logpsi_t, pre_t, logm_t, valid_dst.astype(np.int8)


def assert_close(ref, port, tol=SUM_TOL):
    (rn, rr), (pn, pr) = ref, port
    rn, rr = np.asarray(rn), np.asarray(rr)
    pn, pr = pn.numpy(), pr.numpy()
    assert pn.shape == rn.shape and pr.shape == rr.shape
    assert np.array_equal(rn == NEG_INF, pn == NEG_INF)
    np.testing.assert_allclose(pn, rn, rtol=0, atol=tol)
    np.testing.assert_allclose(pr, rr, rtol=0, atol=tol)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8, 12, 81])
def test_fused_update_t_matches_reference_kernel_and_oracle(s):
    ops = operands_t(37, s, seed=s)
    tops = tuple(torch.from_numpy(x) for x in ops)
    before = dict(TMU.LAUNCHES)
    wrapped = TMU.fused_update_t(*tops)
    assert TMU.LAUNCHES == before            # CPU tensors launch nothing
    plain = fused_update_t_ref(*tops)
    jops = tuple(jnp.asarray(x) for x in ops)
    for port in (wrapped, plain):
        assert_close(JMU.fused_update_t(*jops, interpret=True), port)
        assert_close(JR.fused_update_t_ref(*jops), port)
    new, resid = wrapped
    assert torch.all(new[:, ::5] == NEG_INF) and torch.all(resid[::5] == 0)


def test_fused_update_t_validates_inputs():
    logpsi_t, pre_t, logm_t, dmask_t = (torch.from_numpy(x)
                                        for x in operands_t(6, 3, seed=0))
    with pytest.raises(TypeError, match="dmask_t"):
        TMU.fused_update_t(logpsi_t, pre_t, logm_t, dmask_t.bool())
    with pytest.raises(ValueError, match="logm_t"):
        TMU.fused_update_t(logpsi_t, pre_t, logm_t[:, :5], dmask_t)
    with pytest.raises(ValueError, match="contiguous"):
        TMU.fused_update_t(logpsi_t.transpose(0, 1), pre_t, logm_t, dmask_t)
    with pytest.raises(ValueError, match=r"pre_t must be \(S, E\)"):
        TMU.fused_update_t(logpsi_t, pre_t[0], logm_t, dmask_t)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        TMU.fused_update_t(*(t.to("meta") for t in
                             (logpsi_t, pre_t, logm_t, dmask_t)))


def perturbed_messages(pgm_numpy_mask, base, seed):
    """Messages off the uniform start: valid states jittered, invalid ones
    kept at NEG_INF (the same array goes to both packages)."""
    rng = np.random.default_rng(seed)
    jitter = rng.normal(0.0, 0.7, base.shape).astype(np.float32)
    return np.where(pgm_numpy_mask, base + jitter, NEG_INF).astype(np.float32)


@pytest.mark.parametrize("make", [
    lambda: JD.ising_grid(6, 2.0, seed=1),
    lambda: JD.protein_like_graph(24, seed=2),
    lambda: JD.ldpc_graph(0, n=12, dv=2, dc=4)], ids=["ising", "protein",
                                                      "ldpc"])
def test_pallas_update_matches_reference(make):
    jpgm = make()
    tpgm = bridge(jpgm)
    jlogt, jdm = JO.kernel_operands_t(jpgm)
    tlogt, tdm = TO.kernel_operands_t(tpgm)
    assert np.array_equal(np.asarray(jlogt), tlogt.numpy())
    assert np.array_equal(np.asarray(jdm), tdm.numpy().astype(bool))
    assert TO.kernel_operands_t(tpgm)[0] is tlogt          # built once, kept
    mask = np.asarray(jpgm.state_mask)[np.asarray(jpgm.edge_dst)]
    logm = perturbed_messages(mask, np.asarray(TM.init_messages(tpgm)), 3)
    ref = JO.pallas_update(jpgm, jnp.asarray(logm), interpret=True)
    port = TO.pallas_update(tpgm, torch.from_numpy(logm))
    assert_close(ref, port)
    assert port[0].is_contiguous()


def bucket():
    """The reference's own bucket for its fold tests (tests/test_batch.py)."""
    return ([JD.ising_grid(6, 2.0, seed=s) for s in range(3)]
            + [JD.chain_graph(40, seed=7)])


def test_batched_backends_match_reference():
    jpgms = bucket()
    jbatch = JBatch.from_pgms(jpgms)
    tbatch = TBatch.from_pgms([bridge(p) for p in jpgms])
    b, e, s = jbatch.size, jbatch.n_edges, jbatch.n_states_max
    mask = np.asarray(jax.vmap(lambda p: p.state_mask[p.edge_dst])(
        jbatch.pgm))
    init = np.array(jax.vmap(JO.M.init_messages)(jbatch.pgm))
    for seed in (0, 1):
        logm = init if seed == 0 else perturbed_messages(mask, init, seed)
        jl, tl = jnp.asarray(logm), torch.from_numpy(logm)
        assert_close(JO.pallas_update_batch(jbatch.pgm, jl, interpret=True),
                     TO.pallas_update_batch(tbatch, tl))
        assert_close(JO.triton_update_batch(jbatch.pgm, jl, interpret=True),
                     TO.triton_update_batch(tbatch, tl))
        jc, jr = JO.triton_update_batch(jbatch.pgm, jl, interpret=True,
                                        semiring="max")
        tc, tr = TO.make_triton_update_batch(semiring="max")(tbatch, tl)
        assert tc.shape == (b, e, s) and tr.shape == (b, e)
        assert np.array_equal(np.asarray(jc), tc.numpy())
        assert np.array_equal(np.asarray(jr), tr.numpy())
        for name in TO.BATCH_BACKEND_NAMES:
            bc, br = TO.get_batch_update_fn(name)(tbatch, tl)
            fc, fr = TO.get_update_fn(name)(tbatch.folded(),
                                            tl.reshape(b * e, s))
            assert torch.equal(bc, fc.reshape(b, e, s))
            assert torch.equal(br, fr.reshape(b, e))


def test_pallas_engine_matches_reference():
    jpgm = JD.ising_grid(7, 2.0, seed=4)
    cfg = dict(scheduler="lbp", eps=1e-3, max_rounds=300, backend="pallas")
    jres = JEngine(JConfig(**cfg)).run(jpgm, jax.random.key(0))
    tres = TEngine(TConfig(**cfg), device="cpu").run(
        bridge(jpgm), torch.Generator().manual_seed(0))
    assert int(tres.rounds) == int(jres.rounds) and bool(tres.converged)
    np.testing.assert_allclose(np.exp(tres.beliefs.numpy()),
                               np.exp(np.asarray(jres.beliefs)), rtol=0,
                               atol=1e-4)
