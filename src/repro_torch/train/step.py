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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.convert import (params_to_reference,
                                        stack_like_reference,
                                        unstack_reference)
from repro_torch.models.model import Model, stacked_ndim
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, cosine_lr)

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
    are). They require grad from here on."""
    model.float()
    model.init_params(generator)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def train_state_specs(model: Model) -> TrainState:
    """The state's shapes and dtypes as tensors on the meta device
    (nothing allocated)."""
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


def make_train_step(model: Model, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    microbatches: int = 1, remat: bool = True,
                    grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics), updating
    ``state`` in place. Metrics are 0-d tensors on the device (the
    forward's, plus ``grad_norm`` and ``lr``); nothing is read back.

    With microbatches > 1, the leading batch dim of every batch array is
    split into that many chunks; float32 gradients accumulate in the
    masters' ``.grad`` and are divided by the count, and the metrics are
    averaged, as the reference's scan does. ``grad_shardings`` (the
    reference's FSDP gradient constraint) raises NotImplementedError
    unless None."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings is not ported yet (ROADMAP queue 1, item 14c-2: "
            "sharded training over torch.distributed); pass None")

    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} does not split into "
                             f"{microbatches} microbatches")
        return x.reshape((microbatches, b // microbatches) + x.shape[1:])

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
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
        lr = cosine_lr(state.step, base_lr=base_lr, warmup=warmup,
                       total=total_steps)
        _, _, gnorm = adamw_update(params, grads, state.opt, lr=lr)
        del grads
        state.step.add_(1)
        return state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


# ----------------------------------------------------------- checkpoints --

def reference_tree(state: TrainState) -> TrainState:
    """The state in the reference's layout, on the host: masters and
    moments as float32 numpy trees with the layers stacked, count and step
    as int32. ``checkpoint.save_pytree`` writes it under the reference's
    keys (``.params/['blocks']/['attn']/['wq']``, ``.opt/.count``, ...)."""
    return TrainState(
        params=params_to_reference(state.params),
        opt=AdamWState(mu=params_to_reference(state.opt.mu),
                       nu=params_to_reference(state.opt.nu),
                       count=state.opt.count.cpu().numpy()),
        step=state.step.cpu().numpy())


def reference_like(state: TrainState) -> TrainState:
    """``reference_tree(state)``'s shapes as zero-stride numpy arrays
    (nothing copied): the ``like`` of ``checkpoint.restore_pytree``."""
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
def load_reference_tree(state: TrainState, tree: Any) -> TrainState:
    """Copy a state in the reference's layout -- ``reference_tree``'s, a
    restored checkpoint's, or the reference's own ``TrainState`` as numpy
    -- into ``state`` in place. Returns ``state``."""
    for mine, theirs in ((state.params, tree.params),
                         (state.opt.mu, tree.opt.mu),
                         (state.opt.nu, tree.opt.nu)):
        flat = unstack_reference(theirs)
        if flat.keys() != mine.keys():
            raise ValueError("the tree's parameters are not the state's: "
                             f"{sorted(flat.keys() ^ mine.keys())[:4]}")
        for n, t in mine.items():
            t.copy_(torch.from_numpy(np.array(flat[n], np.float32)))
    state.opt.count.copy_(torch.tensor(np.asarray(tree.opt.count)))
    state.step.copy_(torch.tensor(np.asarray(tree.step)))
    return state
