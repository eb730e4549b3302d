"""Loopy (Synchronous) BP: every message, every round (paper SS II-B)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import PGM


@dataclasses.dataclass(frozen=True)
class LBP:
    """Loopy (synchronous) BP: the frontier is every real edge, every round.

    ``select`` returns ``(frontier (E,) bool = edge_mask, state)`` -- no
    carried state, no random numbers drawn, so trajectories are
    deterministic. Registry spec ``"lbp"``.
    """

    inner_sweeps: int = 1

    def init(self, pgm: PGM):
        return ()

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        return pgm.edge_mask, state

    def init_batch(self, batch):
        return ()

    def select_batch(self, batch, residuals, eps, generators, state,
                     unconverged):
        return batch.pgm.edge_mask, state
