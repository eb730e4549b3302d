"""Residual BP, bulk-parallel sort-and-select variant (paper SS III-A).

Per round, the k = max(1, p * 2|E|) highest-residual messages form the
frontier. The reference's ``lax.top_k`` becomes ``torch.topk``; ties at the
k-th residual are all admitted (threshold semantics), as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import frontier_size


@dataclasses.dataclass(frozen=True)
class RBP:
    """Residual BP, bulk sort-and-select: top-k residual edges per round.

    ``select`` returns the ``k = max(1, p * 2|E|)`` highest-residual real
    edges as the ``(E,) bool`` frontier (ties at the k-th residual all
    admitted). Deterministic given residuals; no carried state. Registry
    spec ``"rbp"``.
    """

    p: float = 1.0 / 256.0   # frontier multiplier: k = p * 2|E| (paper SS III-D)
    inner_sweeps: int = 1

    def init(self, pgm: PGM):
        return ()

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        k_max = min(max(1, int(round(self.p * pgm.n_real_edges))),
                    residuals.shape[0])
        k = frontier_size(self.p, pgm.n_real_edges, k_max)
        thresh = torch.topk(residuals, k_max).values[k - 1]
        # Only update messages that would actually move (residual > 0); on
        # the last stretch the k-th residual is 0 and padding must not thrash.
        frontier = (residuals >= torch.clamp(thresh, min=1e-30)) & pgm.edge_mask
        return frontier, state
