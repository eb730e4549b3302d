"""Residual BP, bulk-parallel sort-and-select variant (paper SS III-A).

Per round, the k = max(1, p * 2|E|) highest-residual messages form the
frontier. The reference's ``lax.top_k`` becomes ``torch.topk``; ties at the
k-th residual are all admitted (threshold semantics), as in the reference.
On a bucket, one ``topk`` of the ceiling's width runs over the (B, E)
residuals and each graph reads its own k-th value.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import frontier_size, kth_largest


@dataclasses.dataclass(frozen=True)
class RBP:
    """Residual BP, bulk sort-and-select: top-k residual edges per round.

    ``select`` returns the ``k = max(1, p * 2|E|)`` highest-residual real
    edges as the ``(E,) bool`` frontier (ties at the k-th residual all
    admitted). ``k`` comes from the graph's own ``edge_count``; its ceiling
    ``k_max`` from the static ``n_real_edges`` (a bucket's ceiling).
    Deterministic given residuals; no carried state. Registry spec
    ``"rbp"``.
    """

    p: float = 1.0 / 256.0   # frontier multiplier: k = p * 2|E| (paper SS III-D)
    inner_sweeps: int = 1

    def init(self, pgm: PGM):
        return ()

    def _k_max(self, pgm: PGM) -> int:
        return min(max(1, int(round(self.p * pgm.n_real_edges))),
                   pgm.edge_src.shape[-1])

    def _frontier(self, residuals, edge_mask, k_max, k):
        thresh = kth_largest(residuals, k_max, k)
        # Only update messages that would actually move (residual > 0); on
        # the last stretch the k-th residual is 0 and padding must not thrash.
        return (residuals >= torch.clamp(thresh, min=1e-30)) & edge_mask

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        k_max = self._k_max(pgm)
        k = frontier_size(self.p, pgm.edge_count, k_max)
        return self._frontier(residuals, pgm.edge_mask, k_max, k), state

    def init_batch(self, batch):
        return ()

    def select_batch(self, batch, residuals, eps, generators, state,
                     unconverged):
        bp = batch.pgm
        k_max = self._k_max(bp)
        k = batch.memo(("rbp_k", self.p), lambda: batch.per_graph(
            [frontier_size(self.p, c, k_max) for c in bp.edge_count]))
        return self._frontier(residuals, bp.edge_mask, k_max, k), state
