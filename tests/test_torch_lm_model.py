"""The LM stack's model in the port against the JAX reference, every family.

For each of the ten ``ARCH_IDS`` at ``reduced()``, the reference's
``init_params(jax.random.key(0))`` is carried into the port through
``params_from_reference``; the same numpy tokens (and frontend embeddings
for the vision and audio stubs) then go through both packages:

- ``prefill`` logits and every cache leaf within 1e-4 (absolute and
  relative);
- 8 ``decode_step``s from ``init_cache``, logits within 1e-4 at every
  step, and the caches after them;
- cache keys, shapes and dtypes equal to the reference's
  ``init_cache_specs``;
- the reference's decode-matches-prefill check (``tests/
  test_models_smoke.py``) on the port itself;
- the config registries equal field for field.

One ``qwen3_4b`` reduced case at ``dtype="bfloat16"`` checks the storage
dtypes and holds the bf16 model against the reference at max|dlogit| /
max|logit| <= 3e-2. That bound cannot tell float32 scores and unembedding
from bf16 ones, whose rounding moves the logits about as much as the bf16
matmuls' own; ``test_torch_lm_layers.py`` holds the precision of those
computations against controls that break it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro import configs as RC
from repro.models import build_model as ref_build
from repro_torch import configs as TC
from repro_torch.models import build_model, params_from_reference

TOL = 1e-4
B, S, STEPS = 2, 8, 8


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def make_batch(cfg, rng, b=B, s=S):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    return batch


def carried(arch, **replace):
    """(reference model, its params, port model with those params)."""
    rcfg = dataclasses.replace(RC.get(arch).reduced(), **replace)
    cfg = dataclasses.replace(TC.get(arch).reduced(), **replace)
    rmodel = ref_build(rcfg)
    params = rmodel.init_params(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    return rmodel, params, model


@pytest.fixture(scope="module", params=RC.ARCH_IDS)
def run(request):
    """Both packages' prefill and 8 decode steps on one arch, once."""
    arch = request.param
    rmodel, params, model = carried(arch)
    rng = np.random.default_rng(0)
    batch = make_batch(model.cfg, rng)
    out = dict(arch=arch, rmodel=rmodel, model=model)
    out["ref_prefill"] = jax.jit(rmodel.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    out["prefill"] = model.prefill({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    steps = rng.integers(0, model.cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    decode = jax.jit(rmodel.decode_step)
    rcache, cache = rmodel.init_cache(B, S + 4), model.init_cache(B, S + 4)
    out["ref_steps"], out["steps"] = [], []
    for t in range(STEPS):
        rl, rcache = decode(params, rcache, jnp.asarray(steps[t]),
                            jnp.int32(t))
        lg, cache = model.decode_step(cache, torch.from_numpy(steps[t]), t)
        out["ref_steps"].append(rl)
        out["steps"].append(lg)
    out["ref_cache"], out["cache"] = rcache, cache
    return out


def test_prefill_logits_and_caches(run):
    (lg, cache), (rlg, rcache) = run["prefill"], run["ref_prefill"]
    assert lg.shape == rlg.shape == (B, run["model"].cfg.padded_vocab)
    close(lg, rlg)
    assert cache.keys() == rcache.keys()
    for group in rcache:
        assert cache[group].keys() == rcache[group].keys()
        for name, ref in rcache[group].items():
            assert tuple(cache[group][name].shape) == ref.shape, name
            close(cache[group][name], ref)


def test_decode_steps_from_init_cache(run):
    for t, (lg, rlg) in enumerate(zip(run["steps"], run["ref_steps"])):
        close(lg, rlg)
    for group, leaves in run["ref_cache"].items():
        for name, ref in leaves.items():
            close(run["cache"][group][name], ref)


def test_cache_specs_equal_the_reference(run):
    for b, s in ((B, S + 4), (3, 40)):
        spec = run["model"].init_cache_specs(b, s)
        rspec = run["rmodel"].init_cache_specs(b, s)
        assert spec.keys() == rspec.keys()
        for group in rspec:
            assert spec[group].keys() == rspec[group].keys()
            for name, sd in rspec[group].items():
                assert spec[group][name].shape == sd.shape, name
                assert str(spec[group][name].dtype) == f"torch.{sd.dtype}"
        cache = run["model"].init_cache(b, s)
        for group in rspec:
            for name, sd in rspec[group].items():
                assert tuple(cache[group][name].shape) == sd.shape


@pytest.mark.parametrize("arch", [a for a in RC.ARCH_IDS
                                  if a != "whisper_medium"])
def test_decode_matches_prefill_on_the_port(arch):
    """Greedy decode logits at the last prompt position match a fresh
    prefill over the same prefix (the reference's own invariant; whisper's
    decode path has no encoder output, so it is not comparable)."""
    cfg = TC.get(arch).reduced()
    model = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 8),
                         generator=torch.Generator().manual_seed(5))
    full, _ = model.prefill({"tokens": toks})
    cache = model.init_cache(1, 12)
    for t in range(8):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_registry_equals_the_reference(arch):
    assert TC.ARCH_IDS == RC.ARCH_IDS
    cfg, rcfg = TC.get(arch), RC.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(rcfg.reduced())
    for prop in ("padded_vocab", "d_inner", "resolved_head_dim",
                 "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(rcfg, prop)
    assert [dataclasses.asdict(s) for s in cfg.shapes()] == \
        [dataclasses.asdict(s) for s in rcfg.shapes()]


@pytest.mark.parametrize("d", [16, 64, 1024])
def test_sinusoid_is_the_references_at_prefill_and_decode(d):
    from repro.models.model import sinusoidal_positions
    from repro_torch.models.model import sinusoid
    table = sinusoid(torch.arange(40), d)
    np.testing.assert_allclose(table.numpy(), sinusoidal_positions(40, d),
                               rtol=0, atol=1e-6)
    for pos in (0, 17, 39):
        assert torch.equal(sinusoid(torch.tensor(pos), d), table[pos])


def test_qwen3_bfloat16_keeps_the_float32_policy():
    rmodel, params, model = carried("qwen3_4b", dtype="bfloat16")
    sd = model.state_dict()
    assert sd["embed.table"].dtype == torch.float32
    assert sd["final_norm"].dtype == torch.float32
    assert sd["blocks.0.attn.q_norm"].dtype == torch.float32
    assert sd["blocks.0.attn.wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    lg, cache = model.prefill({"tokens": torch.from_numpy(toks)})
    rlg, rcache = jax.jit(rmodel.prefill)(params,
                                          {"tokens": jnp.asarray(toks)})
    assert lg.dtype == torch.float32
    assert cache["main"]["k"].dtype == torch.bfloat16
    rlg = np.asarray(rlg, np.float32)
    rel = np.abs(lg.numpy() - rlg).max() / np.abs(rlg).max()
    assert rel <= 3e-2, rel
    dcache, rdcache = model.init_cache(2, 4), rmodel.init_cache(2, 4)
    for t in range(3):
        lg, dcache = model.decode_step(dcache, torch.from_numpy(toks[:, t:t + 1]),
                                       t)
        rlg, rdcache = jax.jit(rmodel.decode_step)(
            params, rdcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        rlg = np.asarray(rlg, np.float32)
        assert np.abs(lg.numpy() - rlg).max() / np.abs(rlg).max() <= 3e-2
