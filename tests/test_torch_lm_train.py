"""The LM stack's training forward in the port against the JAX reference.

For each of the ten ``ARCH_IDS`` at ``reduced()``, the reference's
``init_params(jax.random.key(0))`` is carried into the port and the same
numpy batch (tokens, labels with masked positions, and frontend
embeddings for the vision and audio stubs) goes through both packages'
``forward_train`` (remat on, as both default):

- the loss and every metric within 1e-5 relative, the same metric keys;
- every gradient leaf within 1e-4 of its largest magnitude against
  ``jax.grad`` of the reference's loss (the reference's stacked leaves
  unstacked by layer).

Separate tests pin label masking, the vision frontend's label padding, the
MTP loss (deepseek), the enc-dec path (whisper), remat on vs off (bitwise
in the port), training through two query blocks (S = 1,024), the
stacked-ndim rule that decides the casts and the weight carry back to the
reference's layout.
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
from repro_torch.models.convert import (params_to_reference,
                                        unstack_reference)
from repro_torch.models.model import stacked_ndim

METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16


def make_batch(cfg, rng, b=B, s=S):
    """Tokens, labels (the first three of row 0 masked) and the frontend
    stubs' embeddings, as numpy."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    return batch


def carried(arch, **replace):
    """(reference model, its params, port model with those params, its
    parameters requiring grad)."""
    rcfg = dataclasses.replace(RC.get(arch).reduced(), **replace)
    cfg = dataclasses.replace(TC.get(arch).reduced(), **replace)
    rmodel = ref_build(rcfg)
    params = rmodel.init_params(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    tensors = dict(model.named_parameters())
    for p in tensors.values():
        p.requires_grad_(True)
    return rmodel, params, model, tensors


def port_run(model, tensors, batch, remat=True):
    """The port's (loss, metrics, {name: gradient})."""
    loss, metrics = model.forward_train(
        tensors, {k: torch.from_numpy(v) for k, v in batch.items()},
        remat=remat)
    grads = torch.autograd.grad(loss, list(tensors.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(tensors.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def ref_run(rmodel, params, batch):
    """The reference's (loss, metrics, {port name: gradient})."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.forward_train(p, jbatch), has_aux=True))(params)
    return loss, metrics, unstack_reference(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module", params=RC.ARCH_IDS)
def run(request):
    """Both packages' forward_train and gradients on one arch, once."""
    rmodel, params, model, tensors = carried(request.param)
    batch = make_batch(model.cfg, np.random.default_rng(0))
    return dict(arch=request.param, model=model,
                port=port_run(model, tensors, batch),
                ref=ref_run(rmodel, params, batch))


def test_loss_and_metrics_equal_the_reference(run):
    (loss, metrics, _), (rloss, rmetrics, _) = run["port"], run["ref"]
    assert metrics.keys() == rmetrics.keys()
    np.testing.assert_allclose(loss.numpy(), np.asarray(rloss),
                               rtol=METRIC_TOL)
    for k, v in rmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v),
                                   rtol=METRIC_TOL, err_msg=k)
    assert int(metrics["n_tokens"]) == int(rmetrics["n_tokens"])


def test_every_gradient_leaf_equals_jax_grad(run):
    grads, rgrads = run["port"][2], run["ref"][2]
    assert grads.keys() == rgrads.keys()
    for name, g in grads.items():
        ref = rgrads[name]
        assert tuple(g.shape) == ref.shape, name
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max()) / scale
        assert err <= GRAD_TOL, (name, err)


def test_masked_labels_are_not_counted():
    """n_tokens counts the unmasked labels; a batch whose masked labels
    change gives the same loss."""
    rmodel, params, model, tensors = carried("qwen3_4b")
    batch = make_batch(model.cfg, np.random.default_rng(1))
    loss, metrics, _ = port_run(model, tensors, batch)
    assert int(metrics["n_tokens"]) == B * S - 3
    other = dict(batch, labels=batch["labels"].copy())
    other["labels"][0, :3] = -7                       # any negative masks
    loss2, _, _ = port_run(model, tensors, other)
    assert torch.equal(loss, loss2)
    every = dict(batch, labels=np.full_like(batch["labels"], -1))
    loss3, metrics3, _ = port_run(model, tensors, every)
    rloss3, rmetrics3, _ = ref_run(rmodel, params, every)
    assert float(loss3) == float(rloss3) == 0.0
    assert int(metrics3["n_tokens"]) == int(rmetrics3["n_tokens"]) == 1


def test_vision_labels_are_padded_over_the_patches():
    rmodel, params, model, tensors = carried("pixtral_12b")
    batch = make_batch(model.cfg, np.random.default_rng(2))
    _, _, labels = model._embed_inputs(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, _, rlabels = rmodel._embed_inputs(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    t = model.cfg.n_frontend_tokens
    assert tuple(labels.shape) == (B, t + S)
    assert bool((labels[:, :t] == -1).all())
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rlabels))
    _, metrics, _ = port_run(model, tensors, batch)
    assert int(metrics["n_tokens"]) == B * S - 3


def test_mtp_and_moe_aux_losses():
    """deepseek: the MTP loss and both MoE aux losses are reported and
    enter the total as the reference weighs them."""
    _, _, model, tensors = carried("deepseek_v3_671b")
    assert model.cfg.mtp and model.cfg.n_experts
    batch = make_batch(model.cfg, np.random.default_rng(3))
    loss, m, _ = port_run(model, tensors, batch)
    assert {"mtp_loss", "lb_loss", "z_loss"} <= m.keys()
    want = m["xent"] + 0.01 * m["lb_loss"] + 1e-3 * m["z_loss"] \
        + 0.3 * m["mtp_loss"]
    assert torch.equal(loss, want)


def test_encdec_metrics():
    _, _, model, tensors = carried("whisper_medium")
    batch = make_batch(model.cfg, np.random.default_rng(4))
    loss, m, _ = port_run(model, tensors, batch)
    assert m.keys() == {"xent", "loss", "n_tokens"}
    assert torch.equal(loss, m["xent"])


@pytest.mark.parametrize("arch", ["qwen3_4b", "granite_moe_3b_a800m",
                                  "mamba2_130m", "whisper_medium",
                                  "deepseek_v3_671b"])
def test_remat_changes_nothing(arch):
    """Per-layer recompute gives the loss and gradients of the plain
    forward, bitwise."""
    _, _, model, tensors = carried(arch)
    batch = make_batch(model.cfg, np.random.default_rng(5))
    a, b = (port_run(model, tensors, batch, remat=r) for r in (True, False))
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_weights_carry_back_to_the_reference_layout(arch):
    """``params_to_reference`` inverts ``params_from_reference``: the
    reference's tree, float32, bitwise."""
    rcfg = RC.get(arch).reduced()
    tree = jax.tree.map(np.asarray, ref_build(rcfg).init_params(
        jax.random.key(0)))
    back = params_to_reference(params_from_reference(
        TC.get(arch).reduced(), tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_stacked_ndim_is_the_references_ndim(arch):
    """The rule the train step and AdamW apply per layer reads the ndim
    each leaf has in the reference's stacked tree."""
    rcfg = RC.get(arch).reduced()
    tree = ref_build(rcfg).param_specs()
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat[".".join(str(getattr(p, "key", p)) for p in path)] = leaf.ndim
    model = build_model(TC.get(arch).reduced(), device="meta")
    for name, p in model.named_parameters():
        parts = name.split(".")
        ref_name = ".".join(parts[:1] + parts[2:]) \
            if parts[0] in ("lead_blocks", "blocks", "enc_blocks") else name
        assert stacked_ndim(name, p) == flat[ref_name], name


@pytest.mark.parametrize("arch", ["qwen3_4b", "deepseek_v3_671b"])
def test_training_through_query_blocks(arch):
    """At S = 1,024 attention (and MLA) runs in two query blocks of 512,
    the path every full-length training step takes: the loss and every
    gradient leaf still equal the reference's."""
    rmodel, params, model, tensors = carried(arch)
    batch = make_batch(model.cfg, np.random.default_rng(6), b=1, s=1024)
    loss, _, grads = port_run(model, tensors, batch)
    rloss, _, rgrads = ref_run(rmodel, params, batch)
    np.testing.assert_allclose(loss.numpy(), np.asarray(rloss),
                               rtol=METRIC_TOL)
    for name, g in grads.items():
        ref = rgrads[name]
        err = float(np.abs(g.numpy() - ref).max()) / \
            max(float(np.abs(ref).max()), 1e-30)
        assert err <= GRAD_TOL, (name, err)
