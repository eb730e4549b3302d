"""Structure-aware relaxed residual BP (Knoll et al. / arxiv 1206.5291).

The port of ``repro.core.schedulers.rlxtree``. ``rlx`` cuts the edge axis
into queues by storage order, which carries no structural meaning.
``rlxtree`` applies the same relaxed multi-queue selection in
**destination-vertex order**: the scheduler state is a permutation that
stably sorts real edges by ``edge_dst`` (padding last), computed once in
``init`` (``torch.sort(stable=True)``). Contiguous queues of the permuted
residuals are then contiguous runs of destination vertices -- each queue a
neighborhood -- so a queue's local top-k pops a message together with its
structural competitors.

On a bucket the permutation is ``(B, E)``, one row per graph, computed by
one batched stable sort, and the gathers and scatters run along the last
axis. Everything else -- the draw, ``select_with``, the knobs -- is
``rlx``'s.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.rlx import (RLX, queue_count,
                                             relaxed_frontier)

__all__ = ["RLXTree"]


@dataclasses.dataclass(frozen=True)
class RLXTree(RLX):
    """Relaxed multi-queue residual BP with structure-aware queues: edges
    are queued in destination-vertex order, so each queue covers a
    contiguous vertex neighborhood (tree/factor locality, arxiv 1206.5291).

    Same selection core and knobs as ``rlx`` (``queues``, ``sample``,
    ``p``); differs only in queue membership. ``init`` computes a stable
    sort of ``edge_dst`` (masked edges last), carried as the scheduler
    state; ``select`` gathers residuals through it, runs the per-queue
    top-k of a sampled queue subset, and scatters the frontier back to
    storage order. Registry spec ``"rlxtree"``.
    """

    @staticmethod
    def _order(edge_mask, edge_dst, n_vertices: int) -> torch.Tensor:
        # Stable: storage (even-pair) order within a destination; padded
        # edges sort past every real one, into the trailing queues.
        key = torch.where(edge_mask, edge_dst, n_vertices)
        return torch.sort(key, dim=-1, stable=True).indices

    def init(self, pgm: PGM):
        return self._order(pgm.edge_mask, pgm.edge_dst, pgm.n_vertices)

    def init_batch(self, batch):
        return self._order(batch.pgm.edge_mask, batch.pgm.edge_dst,
                           batch.n_vertices)

    def _frontier(self, pgm: PGM, residuals, k, uniforms, state):
        e = residuals.shape[-1]
        q = queue_count(e, self.queues)
        res = torch.where(pgm.edge_mask, residuals, 0.0).gather(-1, state)
        perm = relaxed_frontier(res.reshape(res.shape[:-1] + (q, e // q)), k,
                                self.sample, uniforms).reshape(res.shape)
        frontier = torch.zeros_like(perm).scatter(-1, state, perm)
        return frontier & pgm.edge_mask
