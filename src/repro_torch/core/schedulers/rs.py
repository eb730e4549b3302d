"""Residual Splash, bulk-parallel variant (paper SS III-A; Gonzalez et al. 09).

Vertex residual = max residual over incoming messages. The top-k vertices
are the roots; the splash is the depth-h ball around each root, found by an
h-hop mask expansion over the edge list, and the engine then applies ``h``
masked update sweeps inside it (``inner_sweeps``). The reference's
``segment_max`` becomes ``scatter_reduce(reduce="amax")`` from a zero base,
which is deterministic on every device. A bucket runs the same code on its
disjoint union (``BatchedPGM.folded()``), with the vertex residuals viewed
as (B, V) for the per-graph top-k. Paper locks h = 2.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import frontier_size, kth_largest


def _segment_max(values: torch.Tensor, dst: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Per-vertex max of ``values`` over edges into it, from a zero base
    (values are >= 0, so empty segments read 0)."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, dst, values, reduce="amax")


@dataclasses.dataclass(frozen=True)
class RS:
    """Residual Splash: top-k residual *vertices*, each updated with a
    depth-``h`` splash (the BFS ball around the root).

    ``select`` returns the ``(E,) bool`` mask of all edges inside the
    h-hop balls of the ``k = max(1, p * V)`` highest-residual vertices
    (``V`` the graph's own ``vertex_count``; vertices past it are padding);
    the engine then applies ``inner_sweeps == h`` masked update passes
    inside that frontier. Deterministic; no carried state. Registry spec
    ``"rs"``.
    """

    p: float = 1.0 / 128.0
    h: int = 2
    inner_sweeps: int = 2  # keep == h

    def init(self, pgm: PGM):
        return ()

    def _k_max(self, pgm: PGM) -> int:
        return min(max(1, int(round(self.p * pgm.n_real_vertices))),
                   pgm.log_psi_v.shape[-2])

    def _frontier(self, pgm: PGM, residuals, shape, real, k_max, k):
        """Frontier over ``pgm``'s flat edge list (one graph, or a bucket's
        union) with vertex residuals viewed as ``shape`` ((V,) or (B, V));
        ``real`` is the graph's vertex count, or a (B, V) mask of real
        vertices."""
        n = pgm.n_vertices
        dst = pgm.edge_dst.long()
        src = pgm.edge_src.long()
        vres = _segment_max(torch.where(pgm.edge_mask, residuals, 0.0), dst,
                            n).reshape(shape)
        if isinstance(real, int):
            vres[real:] = 0.0                 # dummy + padding vertices
        else:
            vres = torch.where(real, vres, 0.0)
        thresh = kth_largest(vres, k_max, k)
        in_ball = (vres >= torch.clamp(thresh, min=1e-30)).reshape(n)
        # Expand the ball h hops: a vertex joins if any neighbour is in.
        for _ in range(self.h):
            hop = _segment_max((in_ball[src] & pgm.edge_mask).to(torch.int32),
                               dst, n)
            in_ball = in_ball | (hop > 0)
        return in_ball[src] & in_ball[dst] & pgm.edge_mask

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        k_max = self._k_max(pgm)
        k = frontier_size(self.p, pgm.vertex_count, k_max)
        return self._frontier(pgm, residuals, (pgm.n_vertices,),
                              pgm.vertex_count, k_max, k), state

    def init_batch(self, batch):
        return ()

    def select_batch(self, batch, residuals, eps, generators, state,
                     unconverged):
        bp = batch.pgm
        k_max = self._k_max(bp)
        k = batch.memo(("rs_k", self.p), lambda: batch.per_graph(
            [frontier_size(self.p, c, k_max) for c in bp.vertex_count]))
        frontier = self._frontier(batch.folded(), residuals.reshape(-1),
                                  (batch.size, batch.n_vertices),
                                  batch.real_vertices(), k_max, k)
        return frontier.reshape(residuals.shape), state
