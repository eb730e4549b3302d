"""Residual Splash, bulk-parallel variant (paper SS III-A; Gonzalez et al. 09).

Vertex residual = max residual over incoming messages. The top-k vertices
are the roots; the splash is the depth-h ball around each root, found by an
h-hop mask expansion over the edge list, and the engine then applies ``h``
masked update sweeps inside it (``inner_sweeps``). The reference's
``segment_max`` becomes ``scatter_reduce(reduce="amax")`` from a zero base,
which is deterministic on every device. Paper locks h = 2.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import frontier_size


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
    h-hop balls of the ``k = max(1, p * V)`` highest-residual vertices;
    the engine then applies ``inner_sweeps == h`` masked update passes
    inside that frontier. Deterministic; no carried state. Registry spec
    ``"rs"``.
    """

    p: float = 1.0 / 128.0
    h: int = 2
    inner_sweeps: int = 2  # keep == h

    def init(self, pgm: PGM):
        return ()

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        n_v = pgm.n_vertices
        dst = pgm.edge_dst.long()
        src = pgm.edge_src.long()
        vres = _segment_max(torch.where(pgm.edge_mask, residuals, 0.0), dst,
                            n_v)
        vres[pgm.n_real_vertices:] = 0.0      # dummy + padding vertices
        k_max = min(max(1, int(round(self.p * pgm.n_real_vertices))), n_v)
        k = frontier_size(self.p, pgm.n_real_vertices, k_max)
        thresh = torch.topk(vres, k_max).values[k - 1]
        in_ball = vres >= torch.clamp(thresh, min=1e-30)
        # Expand the ball h hops: a vertex joins if any neighbour is in.
        for _ in range(self.h):
            hop = _segment_max((in_ball[src] & pgm.edge_mask).to(torch.int32),
                               dst, n_v)
            in_ball = in_ball | (hop > 0)
        frontier = in_ball[src] & in_ball[dst] & pgm.edge_mask
        return frontier, state
