"""The port's optimizer, train step, checkpoints and launcher against the
JAX reference (``repro.train``, ``repro.checkpoint``, ``repro.launch``).

- ``adamw_update`` on identical gradients within 1e-6 of the largest
  magnitude of each leaf of the reference's parameters and moments, with
  the global norm above and below the clip; the decay
  rule read on the reference's stacked tree (a block's norms decay, the
  MTP head's and ``final_norm`` do not); ``cosine_lr`` within 2 float32
  ulps (the two packages' ``cos`` differ in the last bit);
- train steps for the dense, MoE, SSM, enc-dec and MTP families from the
  reference's own ``init_train_state``: parameters within the reference's
  5e-3 (``tests/test_models_smoke.py``), metrics within 1e-5 relative;
- twins of ``TestTrainingConvergence``: the loss falls by more than 0.2 in
  25 steps, two microbatches equal one;
- a run checkpointed and resumed bitwise the unbroken one, through the
  launcher; checkpoints cross-loaded both ways between the packages;
- bf16: the port's loss within 6e-4 relative of the reference's on weights
  whose norms and table lose 0.19 % to bf16 rounding, all in one
  direction; controls that leave the stacked norms or the table uncast
  miss the reference by 2e-3 and fail the same check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro import configs as RC
from repro.checkpoint import restore_pytree as ref_restore
from repro.checkpoint import save_pytree as ref_save
from repro.models import build_model as ref_build
from repro.train import optimizer as RO
from repro.train import step as RS
from repro_torch import configs as TC
from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.configs.base import TRAIN_4K
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import stack_like_reference
from repro_torch.train import optimizer as TO
from repro_torch.train.step import (compute_params, init_train_state,
                                    load_reference_tree, make_train_step,
                                    reference_like, reference_tree,
                                    train_state_specs)

PARAM_TOL = 5e-3          # the reference's own bound after a step
METRIC_TOL = 1e-5
BF16_LOSS_TOL = 6e-4


def np_batch(cfg, rng, b=2, s=16):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    return batch


def both_states(arch, seed=0, **replace):
    """(reference model, its TrainState, port model, the port's state
    holding the same masters)."""
    rcfg = dataclasses.replace(RC.get(arch).reduced(), **replace)
    cfg = dataclasses.replace(TC.get(arch).reduced(), **replace)
    rmodel = ref_build(rcfg)
    rstate = RS.init_train_state(rmodel, jax.random.key(seed))
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator())
    load_reference_tree(state, jax.tree.map(np.asarray, rstate))
    return rmodel, rstate, model, state


def assert_states_close(state, rstate, tol=PARAM_TOL):
    mine = reference_tree(state)
    theirs = jax.tree.map(np.asarray, rstate)
    assert jax.tree.structure(mine.params) == \
        jax.tree.structure(theirs.params)
    for a, b in zip(jax.tree.leaves(mine.params),
                    jax.tree.leaves(theirs.params)):
        assert float(np.abs(a - b).max()) < tol
    assert int(mine.step) == int(theirs.step)
    assert int(mine.opt.count) == int(theirs.opt.count)


def assert_metrics_close(metrics, rmetrics, tol=METRIC_TOL):
    assert metrics.keys() == rmetrics.keys()
    for k, v in rmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=tol,
                                   err_msg=k)


# ------------------------------------------------------------------ AdamW --

SHAPES = {"embed.table": (32, 8), "final_norm": (8,), "blocks.0.ln1": (8,),
          "blocks.1.ln1": (8,), "blocks.0.attn.wq": (8, 8),
          "blocks.1.attn.wq": (8, 8), "blocks.0.ssm.A_log": (4,),
          "blocks.1.ssm.A_log": (4,), "mtp.block.ln1": (8,)}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["below_clip", "above_clip"])
def test_adamw_update_equals_the_reference(grad_scale):
    rng = np.random.default_rng(0)
    p = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in SHAPES.items()}
    params = {n: torch.from_numpy(v.copy()) for n, v in p.items()}
    state = TO.adamw_init(params)
    rparams = stack_like_reference(p)
    rstate = RO.adamw_init(rparams)
    for _ in range(2):
        g = {n: (grad_scale * rng.standard_normal(s)).astype(np.float32)
             for n, s in SHAPES.items()}
        _, _, gnorm = TO.adamw_update(
            params, {n: torch.from_numpy(v) for n, v in g.items()}, state,
            lr=torch.tensor(1e-2))
        rparams, rstate, rgnorm = RO.adamw_update(
            rparams, stack_like_reference(g), rstate, lr=jnp.float32(1e-2))
        assert (float(gnorm) > 1.0) == (grad_scale > 1)
        np.testing.assert_allclose(float(gnorm), float(rgnorm), rtol=1e-6)
        for mine, theirs in ((params, rparams), (state.mu, rstate.mu),
                             (state.nu, rstate.nu)):
            mine = stack_like_reference({n: t.numpy()
                                         for n, t in mine.items()})
            for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
                b = np.asarray(b)
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
        assert int(state.count) == int(rstate.count)


def test_decay_follows_the_stacked_ndim():
    """With zero gradients only the decay moves a parameter: every leaf
    with ndim >= 2 on the reference's stacked tree (the tables, matrices,
    each block's norms and SSM vectors) shrinks by lr * wd; final_norm
    and the unstacked MTP norm keep their values."""
    params = {n: torch.ones(s) for n, s in SHAPES.items()}
    TO.adamw_update(params, {n: torch.zeros(s) for n, s in SHAPES.items()},
                    TO.adamw_init(params), lr=0.5, weight_decay=0.1)
    decayed = {n for n, t in params.items() if float(t[0].flatten()[0]) < 1}
    assert decayed == {"embed.table", "blocks.0.ln1", "blocks.1.ln1",
                       "blocks.0.attn.wq", "blocks.1.attn.wq",
                       "blocks.0.ssm.A_log", "blocks.1.ssm.A_log"}
    assert all(torch.equal(params[n], torch.full(SHAPES[n], 0.95))
               for n in decayed)


def test_cosine_lr_equals_the_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    for warmup, total in ((0, 10), (5, 20), (100, 30), (2, 10)):
        got = TO.cosine_lr(torch.from_numpy(steps), base_lr=3e-4,
                           warmup=warmup, total=total).numpy()
        want = np.asarray(RO.cosine_lr(jnp.asarray(steps), base_lr=3e-4,
                                       warmup=warmup, total=total))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_max_ulp(got, want, maxulp=2)


# ------------------------------------------------------------- train step --

@pytest.mark.parametrize("arch,microbatches", [
    ("qwen3_4b", 1), ("qwen3_4b", 2), ("granite_moe_3b_a800m", 1),
    ("mamba2_130m", 1), ("whisper_medium", 1), ("deepseek_v3_671b", 1)])
def test_train_steps_equal_the_reference(arch, microbatches):
    rmodel, rstate, model, state = both_states(arch)
    batch = np_batch(model.cfg, np.random.default_rng(0))
    kw = dict(base_lr=1e-3, warmup=0, total_steps=10,
              microbatches=microbatches)
    rstep = jax.jit(RS.make_train_step(rmodel, **kw))
    step = make_train_step(model, **kw)
    for _ in range(2):
        rstate, rmetrics = rstep(rstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        assert_metrics_close(metrics, rmetrics)
    assert_states_close(state, rstate)


def test_loss_decreases_small_model():
    """Twin of the reference's ``test_loss_decreases_small_model``."""
    cfg = TC.get("starcoder2_3b").reduced()
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    shape = dataclasses.replace(TRAIN_4K, seq_len=64, global_batch=8)
    pipe = SyntheticLM(cfg, shape, device="cpu")
    step = make_train_step(model, base_lr=1e-3, warmup=5, total_steps=60)
    losses = [float(step(state, pipe.batch(i))[1]["loss"])
              for i in range(25)]
    assert losses[-1] < losses[0] - 0.2, losses


def test_microbatch_equivalence():
    """Twin of the reference's ``test_microbatch_equivalence``: gradient
    accumulation over 2 microbatches equals the single-batch step."""
    cfg = TC.get("qwen3_4b").reduced()
    shape = dataclasses.replace(TRAIN_4K, seq_len=32, global_batch=4)
    batch = SyntheticLM(cfg, shape, device="cpu").batch(0)
    out = []
    for micro in (1, 2):
        model = build_model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(1))
        out.append(make_train_step(model, microbatches=micro)(state, batch))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m1["xent"]), float(m2["xent"]),
                               rtol=1e-4)
    assert max(float((s1.params[n] - s2.params[n]).detach().abs().max())
               for n in s1.params) < PARAM_TOL
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(build_model(cfg, device="cpu"), microbatches=3)(
            s1, batch)


def test_grad_shardings_is_item_14c():
    """Item 14c-2 ported ``grad_shardings``: the parameters' own layout is
    accepted (the port's gradients are always laid out so); any other
    raises ``ValueError``."""
    from repro_torch.launch.sharding import P
    model = build_model(TC.get("qwen3_4b").reduced(), device="cpu")
    own = {n: P(*[None] * p.dim()) for n, p in model.named_parameters()}
    make_train_step(model, grad_shardings=own)
    with pytest.raises(ValueError, match="grad_shardings"):
        make_train_step(model, grad_shardings={})
    with pytest.raises(ValueError, match="embed.table"):
        make_train_step(model, grad_shardings=dict(
            own, **{"embed.table": P("model", None)}))


def test_train_state_specs_allocate_nothing():
    cfg = TC.get("granite_moe_3b_a800m").reduced()
    specs = train_state_specs(build_model(cfg, device="cpu"))
    model = build_model(cfg, device="cpu")
    assert specs.params.keys() == dict(model.named_parameters()).keys()
    for n, p in model.named_parameters():
        for tree in (specs.params, specs.opt.mu, specs.opt.nu):
            assert tree[n].shape == p.shape and tree[n].is_meta
            assert tree[n].dtype == torch.float32
    assert specs.step.dtype == specs.opt.count.dtype == torch.int32
    rspecs = RS.train_state_specs(ref_build(RC.get(
        "granite_moe_3b_a800m").reduced()))
    like = reference_like(specs)
    for mine, theirs in ((like.params, rspecs.params),
                         (like.opt.mu, rspecs.opt.mu),
                         (like.opt.nu, rspecs.opt.nu)):
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        assert [x.shape for x in jax.tree.leaves(mine)] == \
            [x.shape for x in jax.tree.leaves(theirs)]
    assert like.step.shape == rspecs.step.shape == ()


def test_init_train_state_masters_are_the_models_parameters():
    """The masters are float32 and are the model's own parameters (its
    storage converted), drawn as init_params draws them."""
    cfg = dataclasses.replace(TC.get("qwen3_4b").reduced(), dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    state = init_train_state(model, torch.Generator().manual_seed(3))
    drawn = build_model(dataclasses.replace(cfg, dtype="float32"),
                        device="cpu").init_params(
        torch.Generator().manual_seed(3))
    for n, p in model.named_parameters():
        assert p is state.params[n] and p.dtype == torch.float32
        assert p.requires_grad
        assert torch.equal(p.detach(), dict(drawn.named_parameters())[n])
    cast = compute_params(model, state.params)
    assert cast["blocks.0.ln1"].dtype == torch.bfloat16      # stacked norm
    assert cast["embed.table"].dtype == torch.bfloat16
    assert cast["final_norm"].dtype == torch.float32


# ------------------------------------------------------------ checkpoints --

def test_resume_through_the_launcher_is_bitwise(tmp_path, capsys):
    """The launcher on the CPU: 6 steps checkpointed every 3; with the
    last checkpoint removed, a second launch resumes at step 3 and writes
    a step-6 checkpoint bitwise the unbroken run's."""
    argv = ["--arch", "qwen3_4b", "--reduced", "--steps", "6", "--batch",
            "4", "--seq", "32", "--device", "cpu", "--ckpt-every", "3",
            "--log-every", "1", "--microbatches", "2"]
    full = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "step     5 loss=" in out and "straggler events" in out
    assert latest_step(str(tmp_path / "a")) == 6
    import shutil
    shutil.copytree(tmp_path / "a" / "step_000000003",
                    tmp_path / "b" / "step_000000003")
    resumed = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 3" in capsys.readouterr().out
    for n, p in full.params.items():
        assert torch.equal(p, resumed.params[n]), n
        assert torch.equal(full.opt.mu[n], resumed.opt.mu[n])
        assert torch.equal(full.opt.nu[n], resumed.opt.nu[n])
    a = np.load(tmp_path / "a" / "step_000000006" / "data.npz")
    b = np.load(tmp_path / "b" / "step_000000006" / "data.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_launcher_model_parallel_is_item_14c(capsys):
    """Item 14c-2 ported ``--model-parallel`` above 1: with no world the
    launcher makes a world of one, whose elastic mesh shrinks the "model"
    axis to the one rank, and trains."""
    state = launch_train.main(["--arch", "qwen3_4b", "--reduced", "--device",
                               "cpu", "--model-parallel", "2", "--steps",
                               "2", "--batch", "2", "--seq", "16",
                               "--log-every", "1"])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1} (tp)" in out
    assert "step     1 loss=" in out and int(state.step) == 2


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference saves its state after a step; the port restores it
    and steps as the reference does."""
    rmodel, rstate, model, state = both_states("granite_moe_3b_a800m",
                                               seed=2)
    batch = np_batch(model.cfg, np.random.default_rng(1))
    kw = dict(base_lr=1e-3, warmup=1, total_steps=10)
    rstep = jax.jit(RS.make_train_step(rmodel, **kw))
    rstate, _ = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_save(str(tmp_path), 1, rstate, extra={"data_step": 1})
    fresh = init_train_state(build_model(model.cfg, device="cpu"),
                             torch.Generator().manual_seed(9))
    tree, extra = restore_pytree(str(tmp_path), 1, reference_like(fresh))
    load_reference_tree(fresh, tree)
    assert extra == {"data_step": 1} and int(fresh.step) == 1
    assert_states_close(fresh, rstate, tol=1e-30)      # bitwise
    rstate, rmetrics = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    fresh, metrics = make_train_step(model, **kw)(
        fresh, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_metrics_close(metrics, rmetrics)
    assert_states_close(fresh, rstate)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    rmodel, rstate, model, state = both_states("deepseek_v3_671b", seed=3)
    batch = np_batch(model.cfg, np.random.default_rng(2))
    kw = dict(base_lr=1e-3, warmup=1, total_steps=10)
    step = make_train_step(model, **kw)
    state, _ = step(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    save_pytree(str(tmp_path), 1, reference_tree(state),
                extra={"data_step": 1})
    restored, extra = ref_restore(str(tmp_path), 1, rstate)
    assert extra == {"data_step": 1}
    assert_states_close(state, restored, tol=1e-30)    # bitwise
    rstate, rmetrics = jax.jit(RS.make_train_step(rmodel, **kw))(
        restored, {k: jnp.asarray(v) for k, v in batch.items()})
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert_metrics_close(metrics, rmetrics)
    assert_states_close(state, rstate)


# -------------------------------------------------------------------- bf16 --

UP = np.float32(1 + 0.99 * 2.0 ** -9)       # rounds back down in bf16


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float() \
        .numpy()


def _own_ndim(model, params):
    """Control: the port's per-layer ndim, so the stacked norms stay
    float32."""
    return {n: p.to(model.dtype) if p.ndim >= 2 else p
            for n, p in params.items()}


def _table_uncast(model, params):
    cast = compute_params(model, params)
    cast["embed.table"] = params["embed.table"]
    return cast


@pytest.fixture(scope="module")
def bf16_case():
    """Reduced Qwen3 in bf16 on weights where the cast matters: each
    block's norms bf16 values times ``UP`` and the table 25x the drawn
    one, also bf16 values times ``UP``, so the cast rounds every one of
    them down by 0.19 %; the reference's loss on a batch of 8 x 64."""
    rmodel, rstate, model, _ = both_states("qwen3_4b", dtype="bfloat16")
    rng = np.random.default_rng(0)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "['blocks']" in name and ("norm" in name or "ln" in name):
            return _bf16(1 + 0.25 * rng.standard_normal(x.shape)) * UP
        if "table" in name:
            return _bf16(25 * x) * UP
        return x

    rstate = dataclasses.replace(rstate, params=jax.tree.map(
        jnp.asarray, jax.tree_util.tree_map_with_path(
            perturb, jax.tree.map(np.asarray, rstate.params))))
    batch = {"tokens": rng.integers(0, 256, (8, 64)).astype(np.int32),
             "labels": rng.integers(0, 256, (8, 64)).astype(np.int32)}

    def ref_loss(p):
        cast = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                            if (x.ndim >= 2 and x.dtype == jnp.float32)
                            else x, p)
        return rmodel.forward_train(cast, {k: jnp.asarray(v)
                                           for k, v in batch.items()})[0]
    return rstate, batch, float(jax.jit(ref_loss)(rstate.params))


@pytest.mark.parametrize("cast,passes", [
    (compute_params, True), (_own_ndim, False), (_table_uncast, False)],
    ids=["port", "control_norms_uncast", "control_table_uncast"])
def test_bf16_loss_within_tolerance_and_controls_fail(bf16_case, cast,
                                                      passes):
    rstate, batch, rloss = bf16_case
    cfg = dataclasses.replace(TC.get("qwen3_4b").reduced(), dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator())
    load_reference_tree(state, jax.tree.map(np.asarray, rstate))
    with torch.no_grad():
        loss, _ = model.forward_train(cast(model, state.params),
                                      {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    rel = abs(float(loss) - rloss) / abs(rloss)
    assert (rel <= BF16_LOSS_TOL) == passes, rel
