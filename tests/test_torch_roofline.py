"""The port's roofline cost model (``repro_torch.roofline.kernel_model``)
against the reference's (``repro.roofline.kernel_model``) at
``padded=False`` -- the port's kernels pad nothing -- and the bound that
``chip_smoke.py`` takes from it; the LM stack's ``model_flops`` against
the reference's ``analysis.model_flops`` for every config."""

import pathlib
import sys

import pytest

from repro import configs as RC
from repro.models import build_model as ref_build
from repro.roofline import kernel_model as JK
from repro.roofline.analysis import model_flops as ref_model_flops
from repro_torch import configs as TC
from repro_torch.models import build_model
from repro_torch.roofline import kernel_model as TK
from repro_torch.roofline import model_flops

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the script lives at the repo root)


@pytest.mark.parametrize("semiring", ["sum", "max"])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_costs_equal_the_reference(semiring, dtype_bytes):
    for e in (1, 127, 4096, 1_764_352, 3_996_032):
        for s in (1, 2, 3, 8, 9, 16, 33, 51, 81, 128, 300):
            j = JK.fused_update_cost(e, s, dtype_bytes=dtype_bytes,
                                     semiring=semiring)
            t = TK.fused_update_cost(e, s, dtype_bytes=dtype_bytes,
                                     semiring=semiring)
            assert (t.flops, t.bytes) == (j.flops, j.bytes), (e, s)
    for s in (1, 2, 8, 32, 81, 128):
        assert TK.predicted_intensity(
            s, dtype_bytes=dtype_bytes, semiring=semiring) == \
            JK.predicted_intensity(s, dtype_bytes=dtype_bytes,
                                   semiring=semiring)


def test_unknown_semiring_is_the_reference_error():
    with pytest.raises(ValueError) as ej:
        JK.fused_update_cost(8, 2, semiring="min")
    with pytest.raises(ValueError) as et:
        TK.fused_update_cost(8, 2, semiring="min")
    assert str(et.value) == str(ej.value)


def test_chip_smoke_bound_comes_from_the_model():
    """Every bound the script prints is the model's cost over the card's
    peaks: bytes-bound at every state count on an H100."""
    bw, f32 = TK.card_peaks("NVIDIA H100 80GB HBM3")
    for e, s in ((3_996_032, 2), (1_764_352, 16), (1_024, 81), (384, 51)):
        for semiring in ("sum", "max"):
            cost = TK.fused_update_cost(e, s, semiring=semiring)
            ms, by = cs.bound(e, s, semiring, bw, f32)
            assert by == "bytes"
            assert ms == cost.bytes / bw * 1e3
    assert TK.bound_ms(TK.Cost(1e9, 1.0), bw, f32) == (1e9 / f32 * 1e3,
                                                       "operations")


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_model_flops_equal_the_reference(arch, kind):
    """6ND / 2ND over the published configs' parameters (shapes only: the
    port's model on the meta device, the reference's ``param_specs``),
    MoE experts scaled by top_k / n_experts."""
    cfg, rcfg = TC.get(arch), RC.get(arch)
    params = dict(build_model(cfg, device="meta").named_parameters())
    for n_tokens in (1, 2048, 4096 * 256):
        got = model_flops(params, n_tokens, cfg=cfg, kind=kind)
        want = ref_model_flops(ref_build(rcfg).param_specs(), n_tokens,
                               cfg=rcfg, kind=kind)
        assert got == pytest.approx(want, rel=1e-12)
    if cfg.n_experts:                    # without cfg: every expert active
        assert model_flops(params, 1, kind=kind) > \
            model_flops(params, 1, cfg=cfg, kind=kind)


def test_qwen3_4b_train_flops_per_step():
    """The number phase 19 (c) divides by: 6 x 4,022,795,776 parameters x
    2,048 tokens."""
    params = dict(build_model(TC.get("qwen3_4b"), device="meta")
                  .named_parameters())
    assert sum(p.numel() for p in params.values()) == 4_022_795_776
    assert model_flops(params, 2048) == 6.0 * 4_022_795_776 * 2048
