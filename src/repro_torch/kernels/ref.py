"""Plain torch version of the fused edge-major message-update kernel.

The counterpart of ``repro.kernels.ref.fused_update_e_ref``: the same
masking and normalization semantics in the engine's (E, S) layout, for both
semirings. ``repro_torch.kernels.triton_update.fused_update_e`` runs this
for CPU tensors; on the card the CUDA kernel is held against it.
"""

from __future__ import annotations

import torch

__all__ = ["fused_update_e_ref"]

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
