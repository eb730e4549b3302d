"""Train step factory: loss -> grad -> AdamW, with optional microbatch
gradient accumulation (a port of ``repro.train.step``).

The train state holds float32 masters, as the reference's does. The step
casts, once at entry, every master whose reference twin has ndim >= 2 on
the stacked tree (``stacked_ndim``: matrices, the tables, and each block's
norm weights and SSM vectors) to the compute dtype; gradients flow back
through that cast to the float32 masters. Under float32 the cast is the
master itself.

Unlike the reference's functional step, this one updates the state in
place -- masters, moments, count and step -- and returns it: at full width
the masters, their gradients, two moments and one cast copy are what one
card holds, with no room for a second state.

Checkpoints use the reference's layout (``reference_tree``,
``load_reference_tree``): a state saved here restores in the reference and
the other way round.

On a mesh (a model built with ``mesh=``) the state holds the rank's shards:
masters and moments split like their parameters (``train_state_shardings``),
count and step whole. The forward computes the global batch's loss on every
rank (``Model.forward_train``); each gradient, partial over the ranks that
split the batch's rows, is summed over them in rank order (bucketed), unless
the ZeRO-3 gather's backward already reduce-scattered it; a batch that does
not divide is replicated and its gradient taken as it is, one copy. AdamW
then runs on the shards with the global gradient norm. Checkpoints gather
each leaf whole (``save_pytree(sharding_tree=reference_shardings(...))``)
and shard it again on restore, on any mesh or one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.launch.mesh import axes_group
from repro_torch.launch.sharding import P, shard_tensor
from repro_torch.models.convert import (params_to_reference,
                                        stack_like_reference,
                                        unstack_reference)
from repro_torch.models.model import Model, stacked_ndim
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, cosine_lr)

#: the bytes of gradient summed over the data ranks in one collective
GRAD_BUCKET_BYTES = 1 << 26

@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: AdamWState
    step: torch.Tensor


def init_train_state(model: Model, generator: torch.Generator) -> TrainState:
    """Float32 masters drawn from ``generator`` as ``Model.init_params``
    draws them, zero moments, step 0, on the model's device.

    The masters become the model's own parameters: its storage is
    converted to float32 in place, so nothing parameter-sized is held
    twice, and serving from the model afterwards computes with the trained
    masters (matmul weights cast at use, as the reference's served params
    are). They require grad from here on. On a mesh they are the rank's
    shards of the one-device draw, and so are the moments."""
    model.float()
    model.init_params(generator)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def train_state_specs(model: Model) -> TrainState:
    """The state's global shapes and dtypes as tensors on the meta device
    (nothing allocated), on a mesh too: ``train_state_shardings(mesh,
    train_state_specs(model), mode)`` places it."""
    meta = Model(model.cfg, device="meta").float()
    params = {n: p.detach() for n, p in meta.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def compute_params(model: Model, params: Mapping[str, torch.Tensor]):
    """The tensors a step computes with: each float32 master whose
    reference twin has ndim >= 2 cast to the model's compute dtype, the
    rest as they are (the reference's cast at step entry)."""
    return {n: p.to(model.dtype)
            if stacked_ndim(n, p) >= 2 and p.dtype == torch.float32 else p
            for n, p in params.items()}


def _split_axes(spec) -> tuple:
    """The mesh axes a leaf of ``spec`` is split over."""
    out = ()
    for e in spec or ():
        out += () if e is None else ((e,) if isinstance(e, str) else e)
    return out


def _sum_buckets(grads, names, group) -> None:
    """Replace each of ``grads[names]`` by its rank-order sum over
    ``group``, ``GRAD_BUCKET_BYTES`` of gradient per collective."""
    bucket, size = [], 0
    for i, n in enumerate(names):
        bucket.append(n)
        size += grads[n].numel() * grads[n].element_size()
        if size < GRAD_BUCKET_BYTES and i + 1 < len(names):
            continue
        flat = comm.rank_order_sum(
            torch.cat([grads[m].reshape(-1) for m in bucket]), group)
        for m, part in zip(bucket, torch.split(
                flat, [grads[m].numel() for m in bucket])):
            grads[m] = part.view_as(grads[m])
        bucket, size = [], 0


def make_train_step(model: Model, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    microbatches: int = 1, remat: bool = True,
                    grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics), updating
    ``state`` in place. Metrics are 0-d tensors on the device (the
    forward's, plus ``grad_norm`` and ``lr``); nothing is read back.
    ``train_step.gradients(state, batch)`` returns ``(grads, metrics)``,
    the gradients the update would take (the rank's shards, summed over
    the ranks), and changes nothing.

    With microbatches > 1, the leading batch dim of every batch array is
    split into that many chunks; float32 gradients accumulate in the
    masters' ``.grad`` and are divided by the count, and the metrics are
    averaged, as the reference's scan does. ``grad_shardings`` (the
    reference's FSDP gradient constraint, ``{name: P}``) must be the
    parameters' own shardings: the port's gradients are always the rank's
    shards, and under ZeRO-3 the gather's backward makes them by a
    reduce-scatter; any other layout raises ``ValueError``."""
    specs = {n: model.spec_of(n) for n, _ in model.named_parameters()}
    if grad_shardings is not None:
        def splits(spec):
            return [(d, e) for d, e in enumerate(spec or ()) if e is not None]
        off = [n for n in specs
               if splits(specs[n]) != splits(grad_shardings.get(n))]
        if off or grad_shardings.keys() != specs.keys():
            raise ValueError(
                "grad_shardings must place every gradient as its parameter "
                f"is placed (the rank's shards); differs at {off[:3]}")
    # the groups over which split leaves are held (for the global norm)
    split_group = None
    if model.mesh is not None:
        axes = ("data", "model") if model.mode == "fsdp" else ("model",)
        split_group = axes_group(model.mesh, axes)[1]

    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} does not split into "
                             f"{microbatches} microbatches")
        return x.reshape((microbatches, b // microbatches) + x.shape[1:])

    def sum_over_rows(grads, rows):
        """Sum each gradient over the ranks that split the rows, less the
        axes a ZeRO-3 reduce-scatter already summed it over."""
        plan: Dict[tuple, list] = {}
        for n in grads:
            done = _split_axes(specs[n]) if model.zero3 is not None else ()
            axes = tuple(a for a in rows.axes if a not in done)
            plan.setdefault(axes, []).append(n)
        for axes, names in plan.items():
            group = axes_group(model.mesh, axes)[1]
            if group is not None:
                _sum_buckets(grads, names, group)

    def sq_norm(sq):
        """The global tree's squared norm from the rank's per-leaf sums:
        split leaves' added over their ranks in rank order, replicated
        leaves' once."""
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        held = sum((v for n, v in sq.items() if _split_axes(specs[n])), zero)
        whole = sum((v for n, v in sq.items() if not _split_axes(specs[n])),
                    zero)
        return comm.rank_order_sum(held, split_group) + whole

    def gradients(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        micro = [batch] if microbatches == 1 else [
            {k: v[i] for k, v in parts.items()}
            for parts in [{k: split(v) for k, v in batch.items()}]
            for i in range(microbatches)]
        metrics = None
        with torch.enable_grad():
            for mb in micro:
                loss, m = model.forward_train(compute_params(model, params),
                                              mb, remat=remat)
                loss.backward()
                m = {k: v.detach() for k, v in m.items()}
                metrics = m if metrics is None else {
                    k: metrics[k] + v for k, v in m.items()}
        grads = {}
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads[n] = g.div_(microbatches) if microbatches > 1 else g
        if microbatches > 1:
            metrics = {k: v / microbatches for k, v in metrics.items()}
        rows = model.rows(micro[0]["tokens"].shape[0])
        if rows is not None:
            sum_over_rows(grads, rows)
        return grads, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        grads, metrics = gradients(state, batch)
        lr = cosine_lr(state.step, base_lr=base_lr, warmup=warmup,
                       total=total_steps)
        _, _, gnorm = adamw_update(
            state.params, grads, state.opt, lr=lr,
            sq_norm=None if split_group is None else sq_norm)
        del grads
        state.step.add_(1)
        return state, dict(metrics, grad_norm=gnorm, lr=lr)

    train_step.gradients = gradients
    return train_step


# ----------------------------------------------------------- checkpoints --

def reference_tree(state: TrainState) -> TrainState:
    """The state in the reference's layout, on the host: masters and
    moments as float32 numpy trees with the layers stacked, count and step
    as int32. ``checkpoint.save_pytree`` writes it under the reference's
    keys (``.params/['blocks']/['attn']/['wq']``, ``.opt/.count``, ...). On
    a mesh the leaves are the rank's blocks, stacked: save it with
    ``sharding_tree=reference_shardings(...)``, which gathers them."""
    return TrainState(
        params=params_to_reference(state.params),
        opt=AdamWState(mu=params_to_reference(state.opt.mu),
                       nu=params_to_reference(state.opt.nu),
                       count=state.opt.count.cpu().numpy()),
        step=state.step.cpu().numpy())


def reference_shardings(shardings: TrainState) -> TrainState:
    """``train_state_shardings``' specs (keyed by the port's names) in the
    reference's layout, a stacked leaf's spec led by ``None`` for its layer
    axis: the reference's own ``train_state_shardings`` of its tree, and
    the ``sharding_tree`` of ``reference_tree``'s stacked blocks."""
    def tree(specs):
        return stack_like_reference(
            dict(specs), stack=lambda layers: P(None, *layers[0]))
    return TrainState(params=tree(shardings.params),
                      opt=AdamWState(mu=tree(shardings.opt.mu),
                                     nu=tree(shardings.opt.nu), count=P()),
                      step=P())


def reference_like(state: TrainState) -> TrainState:
    """``reference_tree(state)``'s shapes as zero-stride numpy arrays
    (nothing copied): the ``like`` of ``checkpoint.restore_pytree``. For a
    state on a mesh pass ``train_state_specs(model)``, whose shapes are
    global."""
    def like(shape):
        return np.broadcast_to(np.float32(0), tuple(shape))

    def tree(params):
        return stack_like_reference(
            {n: like(p.shape) for n, p in params.items()},
            stack=lambda layers: like((len(layers),) + layers[0].shape))

    count = np.zeros((), np.int32)
    return TrainState(params=tree(state.params),
                      opt=AdamWState(mu=tree(state.opt.mu),
                                     nu=tree(state.opt.nu), count=count),
                      step=count)


@torch.no_grad()
def load_reference_tree(state: TrainState, tree: Any, shardings=None,
                        mesh=None) -> TrainState:
    """Copy a state in the reference's layout -- ``reference_tree``'s, a
    restored checkpoint's, or the reference's own ``TrainState`` as numpy
    -- into ``state`` in place. Returns ``state``. On a mesh, a whole leaf
    is cut to the rank's block by ``shardings`` (``train_state_shardings``
    of the state, port names) with ``shard_tensor``; a leaf already of the
    block's shape (restored with a ``sharding_tree``) is copied."""
    for mine, theirs, specs in (
            (state.params, tree.params, shardings and shardings.params),
            (state.opt.mu, tree.opt.mu, shardings and shardings.opt.mu),
            (state.opt.nu, tree.opt.nu, shardings and shardings.opt.nu)):
        flat = unstack_reference(theirs)
        if flat.keys() != mine.keys():
            raise ValueError("the tree's parameters are not the state's: "
                             f"{sorted(flat.keys() ^ mine.keys())[:4]}")
        for n, t in mine.items():
            src = torch.from_numpy(np.array(flat[n], np.float32))
            if tuple(src.shape) != tuple(t.shape) and specs is not None:
                src = shard_tensor(src, specs[n], mesh)
            t.copy_(src)
    state.opt.count.copy_(torch.tensor(np.asarray(tree.opt.count)))
    state.step.copy_(torch.tensor(np.asarray(tree.step)))
    return state
