"""The fused update wrapper against the reference kernels.

On CPU tensors ``repro_torch.kernels.triton_update.fused_update_e`` runs
its plain torch version; it must match the reference's Pallas kernel (run
in interpret mode, as the reference's own tests run it on CPU) and the
reference's plain oracle: sum-product within 1e-4 absolute (float32 with
different exp/log implementations), max-product bitwise (add, max and
subtract only). A CUDA tensor on a machine without a GPU must raise rather
than compute. ``test_torch_cuda.py`` holds the CUDA kernel itself against
the plain version where there is a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.kernels import ref as JR
from repro.kernels import triton_update as JT
from repro_torch.kernels import _build
from repro_torch.kernels import message_update as MU
from repro_torch.kernels import triton_update as TT
from repro_torch.kernels.ref import fused_update_e_ref

NEG_INF = -1.0e30
SUM_TOL = 1e-4


def operands(e, s, seed):
    """numpy inputs with NEG_INF invalid states, all-masked rows (every
    5th edge) and rows with no valid source state (every 7th edge)."""
    rng = np.random.default_rng(seed)
    logpsi = rng.normal(0.0, 1.0, (e, s, s)).astype(np.float32)
    valid_dst = rng.random((e, s)) < 0.7
    valid_dst[::5] = False
    valid_src = rng.random((e, s)) < 0.7
    valid_src[::7] = False
    pre = np.where(valid_src, rng.normal(0.0, 2.0, (e, s)),
                   NEG_INF).astype(np.float32)
    logm = np.where(valid_dst, rng.normal(-2.0, 1.0, (e, s)),
                    NEG_INF).astype(np.float32)
    return logpsi, pre, logm, valid_dst.astype(np.int8)


def as_torch(ops):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in ops)


def assert_matches(semiring, ref, port):
    (rn, rr), (pn, pr) = ref, port
    rn, rr = np.asarray(rn), np.asarray(rr)
    pn, pr = pn.numpy(), pr.numpy()
    assert pn.shape == rn.shape and pr.shape == rr.shape
    assert np.array_equal(rn == NEG_INF, pn == NEG_INF)
    if semiring == "max":
        assert np.array_equal(rn, pn) and np.array_equal(rr, pr)
    else:
        np.testing.assert_allclose(pn, rn, rtol=0, atol=SUM_TOL)
        np.testing.assert_allclose(pr, rr, rtol=0, atol=SUM_TOL)


@pytest.mark.parametrize("semiring", ["sum", "max"])
@pytest.mark.parametrize("s", [2, 3, 5, 8])
def test_matches_reference_kernel_and_oracle(s, semiring):
    ops = operands(37, s, seed=s)
    before = dict(TT.LAUNCHES)
    port = TT.fused_update_e(*as_torch(ops), semiring=semiring)
    assert TT.LAUNCHES == before            # CPU tensors launch nothing
    jops = tuple(jnp.asarray(x) for x in ops)
    assert_matches(semiring, JT.fused_update_e(*jops, semiring=semiring,
                                               interpret=True), port)
    assert_matches(semiring, JR.fused_update_e_ref(*jops, semiring=semiring),
                   port)
    # all-masked rows: NEG_INF messages, zero residual
    new, resid = port
    assert torch.all(new[::5] == NEG_INF) and torch.all(resid[::5] == 0)


@pytest.mark.parametrize("s", [1, 12, 81])
def test_plain_version_matches_oracle_any_state_count(s):
    ops = operands(9, s, seed=100 + s)
    for semiring in ("sum", "max"):
        assert_matches(semiring,
                       JR.fused_update_e_ref(*(jnp.asarray(x) for x in ops),
                                             semiring=semiring),
                       fused_update_e_ref(*as_torch(ops), semiring))


def test_wrapper_validates_inputs():
    logpsi, pre, logm, dmask = as_torch(operands(6, 3, seed=0))
    with pytest.raises(ValueError, match="semiring"):
        TT.fused_update_e(logpsi, pre, logm, dmask, semiring="min")
    with pytest.raises(TypeError, match="dmask"):
        TT.fused_update_e(logpsi, pre, logm, dmask.bool())
    with pytest.raises(ValueError, match="logm"):
        TT.fused_update_e(logpsi, pre, logm[:5], dmask)
    with pytest.raises(ValueError, match="contiguous"):
        TT.fused_update_e(logpsi.transpose(1, 2), pre, logm, dmask)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        TT.fused_update_e(*(t.to("meta") for t in (logpsi, pre, logm, dmask)))


def test_cuda_tensor_without_gpu_raises(monkeypatch):
    """CUDA tensors take the kernel path: the dispatcher op's CUDA
    implementation builds the kernel, and with no CUDA toolkit the build
    raises; nothing falls back to the plain version. Fake CUDA tensors go
    to the op's fake implementation: shapes, no build, no launch."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; test_torch_cuda.py covers it")
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(TT, "_lib", None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build._BUILD_DIR / "absent.so")
    before = dict(TT.LAUNCHES)
    with FakeTensorMode():
        ops = (torch.empty(4, 2, 2, device="cuda"),
               torch.empty(4, 2, device="cuda"),
               torch.empty(4, 2, device="cuda"),
               torch.empty(4, 2, dtype=torch.int8, device="cuda"))
        with pytest.raises(RuntimeError, match="nvcc"):
            TT._launch(*ops)
        new, resid = TT.fused_update_e(*ops)
    assert (new.shape, resid.shape, new.device.type) == ((4, 2), (4,), "cuda")
    assert TT._lib is None and TT.LAUNCHES == before


def test_transposed_kernel_cuda_tensor_without_gpu_raises(monkeypatch):
    """``fused_update_t`` on CUDA tensors builds its kernel or raises (the
    dispatcher op's CUDA implementation); with no CUDA toolkit it raises
    and counts no launch. Fake CUDA tensors get shapes only."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; test_torch_cuda.py covers it")
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(MU, "_lib", None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build._BUILD_DIR / "absent.so")
    before = dict(MU.LAUNCHES)
    with FakeTensorMode():
        ops = (torch.empty(3, 3, 5, device="cuda"),
               torch.empty(3, 5, device="cuda"),
               torch.empty(3, 5, device="cuda"),
               torch.empty(3, 5, dtype=torch.int8, device="cuda"))
        with pytest.raises(RuntimeError, match="nvcc"):
            MU._launch(*ops)
        new_t, resid = MU.fused_update_t(*ops)
    assert (new_t.shape, resid.shape) == ((3, 5), (5,))
    assert MU._lib is None and MU.LAUNCHES == before


def test_build_flags_target_hopper_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert "fast_math" not in flags and "ftz" not in flags
    p = _build.library_path("fused_update_e")
    assert p.parent.name == "kernels" and p.parent.parent.name == "build"
    assert p == _build.library_path("fused_update_e")     # stable key
    assert _build.SOURCES == ("fused_update_e", "fused_update_t")
    assert all((_build._CSRC / f"{n}.cu").is_file() for n in _build.SOURCES)
