"""Randomized BP -- the paper's contribution (SS IV).

Frontier = two filters over all directed edges:
  1. *eps filter*: drop messages whose next update moves them < eps,
  2. *random filter*: keep a Bernoulli(p) subset of the survivors -- pure
     elementwise work, no sort, which is the entire point.

Dynamic p (SS IV-A): EdgeRatio = NewEdgeCount / OldEdgeCount of unconverged
edges between consecutive rounds. EdgeRatio > 0.9 means the run is stalling
-> LowP (convergence mode); otherwise HighP (speed mode).

The draw is one (E,) float32 uniform per round from the engine's
``torch.Generator``. torch's generators give other numbers than JAX's
threefry, so ``select_with`` takes the draw as an argument: tests feed both
packages the same uniforms and compare masks bitwise.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM


@dataclasses.dataclass(frozen=True)
class RnBP:
    """Randomized BP (the paper's contribution): eps-filter + Bernoulli(p)
    keep, with a two-mode dynamic p.

    ``select`` keeps each unconverged real edge (residual >= eps) with
    probability ``p``. The carried state is the previous round's
    unconverged count (0-d f32): when the ratio new/old exceeds
    ``ratio_threshold`` the run is stalling and ``low_p`` is used,
    otherwise ``high_p``. Draws one (E,) uniform per round from the
    engine's generator. Registry spec ``"rnbp"``.
    """

    low_p: float = 0.7
    high_p: float = 1.0
    ratio_threshold: float = 0.9
    inner_sweeps: int = 1

    def init(self, pgm: PGM):
        # OldEdgeCount starts at "everything unconverged".
        return torch.tensor(float(pgm.n_real_edges), dtype=torch.float32,
                            device=pgm.device)

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        uniforms = torch.rand(residuals.shape, generator=generator,
                              dtype=torch.float32, device=residuals.device)
        return self.select_with(pgm, residuals, eps, uniforms, state,
                                unconverged)

    def select_with(self, pgm: PGM, residuals: torch.Tensor, eps: float,
                    uniforms: torch.Tensor, state, unconverged: torch.Tensor):
        """``select`` given the round's (E,) uniform draw: pure, so the
        same draw gives the same frontier and controller state as the
        reference's ``select``."""
        new_count = unconverged.to(torch.float32)
        edge_ratio = new_count / torch.clamp(state, min=1.0)
        p = torch.where(edge_ratio > self.ratio_threshold, self.low_p,
                        self.high_p)
        candidates = (residuals >= eps) & pgm.edge_mask
        return candidates & (uniforms < p), new_count
