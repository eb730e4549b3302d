"""AdamW with decoupled weight decay, built from scratch (a port of
``repro.train.optimizer``).

Mixed precision: master weights and moments in float32 whatever the compute
dtype; gradients are upcast. The update runs in place: parameters and
moments are rewritten where they lie (the reference returns new trees; at
full width a second copy of the state would not fit on one card). Every
elementwise step is the reference's, in its order, in float32.

Parameters and gradients are ``{name: tensor}`` mappings in the port's
per-layer naming. Which leaves decay follows the reference's rule on its
own tree, ``ndim >= 2``, read on the stacked tree (``stacked_ndim``): a
block's norm weights, ``A_log``, ``D`` and ``dt_bias`` carry a leading L
axis there, so they decay; the MTP head's norms and ``final_norm`` do not.
On a mesh the leaves are the rank's shards: a shard keeps its leaf's ndim,
so the rule reads the leaf's global name and rank, never its local shape,
and the clipping norm is the global tree's (``sq_norm``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.models.model import stacked_ndim


@dataclasses.dataclass
class AdamWState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    """Zero float32 moments beside ``params``, count 0 (int32), on the
    parameters' device."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return AdamWState(mu=zeros,
                      nu={n: torch.zeros_like(z) for n, z in zeros.items()},
                      count=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *,
                 lr: float | torch.Tensor = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 sq_norm=None):
    """One step with global-norm clipping, in place on ``params`` and
    ``state``. Returns (params, state, grad_norm) as the reference returns
    (new_params, new_state, grad_norm); ``lr`` may be a 0-d tensor on the
    device, so the step reads nothing back to the host.

    ``sq_norm`` maps ``{name: sum of the squares of its gradient}`` to the
    squared norm of the whole gradient tree; by default their sum in
    order. On a mesh the train step passes the global one (shards' sums
    added over the ranks that hold them, replicated leaves once)."""
    g32 = {n: g.float() for n, g in grads.items()}
    sq = {n: torch.sum(torch.square(g)) for n, g in g32.items()}
    gnorm = torch.sqrt(sum(sq.values()) if sq_norm is None
                       else sq_norm(sq))
    scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0) \
        if grad_clip > 0 else 1.0
    state.count.add_(1)
    count = state.count.float()
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    for n, p in params.items():
        g = g32[n] * scale
        mu, nu = state.mu[n], state.nu[n]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        step = (mu / c1).div_(torch.sqrt(nu / c2).add_(eps))
        # decay only matrices (norms/scalars exempt), the usual rule
        wd = weight_decay if stacked_ndim(n, p) >= 2 else 0.0
        p32 = p.float()
        p.copy_(p32 - (wd * p32).add_(step).mul_(lr))
    return params, state, gnorm


def cosine_lr(step: torch.Tensor, *, base_lr: float, warmup: int,
              total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac`` of ``base_lr``,
    computed on the step tensor's device in float32."""
    s = step.float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)
