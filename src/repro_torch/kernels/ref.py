"""Plain torch versions of the fused message-update kernels.

The counterparts of ``repro.kernels.ref``: ``fused_update_e_ref`` has the
edge-major (E, S) layout of the engine, for both semirings;
``fused_update_t_ref`` the TPU's transposed (S, E) layout, sum-product.
The kernel wrappers (``triton_update.fused_update_e``,
``message_update.fused_update_t``) run these for CPU tensors; on the card
the CUDA kernels are held against them.
"""

from __future__ import annotations

import torch

__all__ = ["fused_update_e_ref", "fused_update_t_ref"]

NEG_INF = -1.0e30


def fused_update_e_ref(logpsi: torch.Tensor,   # (E, S, S) [e, x_src, x_dst]
                       pre: torch.Tensor,      # (E, S)
                       logm: torch.Tensor,     # (E, S)
                       dmask: torch.Tensor,    # (E, S) bool-ish
                       semiring: str = "sum"):
    """``(new (E, S), resid (E,))``: propagate ``pre`` through ``logpsi``
    (LSE over source states for ``"sum"``, max for ``"max"``), mask invalid
    destination states to NEG_INF, renormalize over the valid ones (LSE to 0
    for ``"sum"``, peak to 0 for ``"max"``) and take the L-inf residual
    ``max |new - logm|`` over valid states."""
    scores = logpsi + pre[:, :, None]
    dmask = dmask != 0
    if semiring == "max":
        cand = torch.where(dmask, scores.amax(dim=1), NEG_INF)
        z = cand.amax(dim=1)
    elif semiring == "sum":
        m = torch.clamp(scores.amax(dim=1), min=NEG_INF)
        s = torch.exp(scores - m[:, None, :]).sum(dim=1)
        cand = m + torch.log(torch.clamp(s, min=1e-38))
        cand = torch.where(dmask, cand, NEG_INF)
        zm = torch.clamp(cand.amax(dim=1), min=NEG_INF)
        zs = torch.where(dmask, torch.exp(cand - zm[:, None]), 0.0).sum(dim=1)
        z = zm + torch.log(torch.clamp(zs, min=1e-38))
    else:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         "expected one of ['max', 'sum']")
    new = torch.where(dmask, cand - z[:, None], NEG_INF)
    resid = torch.where(dmask, torch.abs(new - logm), 0.0).amax(dim=1)
    return new, resid


def fused_update_t_ref(logpsi_t: torch.Tensor,   # (S, S, E) [x_src, x_dst, e]
                       pre_t: torch.Tensor,      # (S, E)
                       logm_t: torch.Tensor,     # (S, E)
                       dmask_t: torch.Tensor):   # (S, E) bool-ish
    """``(new_t (S, E), resid (E,))``: the sum-product update of
    ``fused_update_e_ref`` with every operand transposed, edges last --
    LSE over source states (axis 0), mask invalid destination states to
    NEG_INF, LSE-renormalize over the valid ones, L-inf residual."""
    scores = logpsi_t + pre_t[:, None, :]
    m = torch.clamp(scores.amax(dim=0), min=NEG_INF)
    s = torch.exp(scores - m[None]).sum(dim=0)
    cand = m + torch.log(torch.clamp(s, min=1e-38))
    dmask = dmask_t != 0
    cand = torch.where(dmask, cand, NEG_INF)
    zm = torch.clamp(cand.amax(dim=0), min=NEG_INF)
    zs = torch.where(dmask, torch.exp(cand - zm[None]), 0.0).sum(dim=0)
    z = zm + torch.log(torch.clamp(zs, min=1e-38))
    new = torch.where(dmask, cand - z[None], NEG_INF)
    resid = torch.where(dmask, torch.abs(new - logm_t), 0.0).amax(dim=0)
    return new, resid
