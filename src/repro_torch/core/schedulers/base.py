"""Scheduler protocol for frontier-based BP (paper Algorithm 1).

The port of ``repro.core.schedulers.base``. A scheduler owns
``GenerateFrontier``: given the fresh residuals of *all* directed edges it
returns a boolean frontier mask plus its own carried state. ``select`` runs
on the graph's device and never reads a value back to the host, so the
engine's round loop does not synchronize with the card every round.

``select`` receives ``unconverged`` (a 0-d tensor: count of edges with
residual >= eps this round) because RnBP's dynamic-p controller consumes
it, and a ``torch.Generator`` on the graph's device for schedulers that
draw random numbers; the others ignore both.
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple

import numpy as np
import torch

from repro_torch.core.graph import PGM

__all__ = ["Scheduler", "frontier_size"]


class Scheduler(Protocol):
    #: number of masked update sweeps the engine applies per selected
    #: frontier (1 for everything except Residual Splash's depth-h splash).
    inner_sweeps: int

    def init(self, pgm: PGM) -> Any:
        """Initial carried state (a tensor, or ``()`` for none)."""
        ...

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state: Any,
               unconverged: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Return ``(frontier_mask (E,) bool, new_state)``."""
        ...


def frontier_size(p: float, count: int, k_max: int) -> int:
    """``clip(round(p * count), 1, k_max)`` computed as the reference
    computes it: the product in float32, rounded half to even."""
    k = np.round(np.float32(p) * np.float32(count))
    return int(np.clip(k, 1, k_max))
