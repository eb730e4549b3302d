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

``init_batch``/``select_batch`` are the bucket's versions (the reference
vmaps ``init``/``select``): residuals ``(B, E)``, state and ``unconverged``
``(B,)``, one generator per graph (``None`` for a graph whose iteration
budget is spent: it draws nothing). One set of launches serves the whole
bucket, and ``select`` is the B-less case of the same code. Frontier sizes
come from each graph's own ``edge_count``/``vertex_count``; the static
``n_real_*`` are the bucket's ceilings and only bound ``k``.
"""

from __future__ import annotations

from typing import Any, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import PGM

__all__ = ["Scheduler", "draw_rows", "frontier_size", "kth_largest"]


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

    def init_batch(self, batch) -> Any:
        """Initial carried state of a ``BatchedPGM`` ((B,) tensor or ())."""
        ...

    def select_batch(self, batch, residuals: torch.Tensor, eps: float,
                     generators: Sequence[torch.Generator | None], state: Any,
                     unconverged: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Return ``(frontier_mask (B, E) bool, new_state)``."""
        ...


def frontier_size(p: float, count: int, k_max: int) -> int:
    """``clip(round(p * count), 1, k_max)`` computed as the reference
    computes it: the product in float32, rounded half to even."""
    k = np.round(np.float32(p) * np.float32(count))
    return int(np.clip(k, 1, k_max))


def kth_largest(values: torch.Tensor, k_max: int, k) -> torch.Tensor:
    """The ``k``-th largest entry (1-based) along the last axis, shape
    ``(..., 1)``: one ``torch.topk`` of width ``k_max``, then ``k`` is a host
    int (one graph) or a (B,) int64 tensor with one ``k`` per row (a
    bucket). ``topk`` returns exact values, so every row gives what its
    graph gives alone."""
    top = torch.topk(values, k_max, dim=-1).values
    if isinstance(k, int):
        return top[..., k - 1:k]
    return top.gather(-1, (k - 1)[:, None])


def draw_rows(shape, generators: Sequence[torch.Generator | None],
              device) -> torch.Tensor:
    """A bucket's round of uniform draws, ``shape = (B, n)`` float32: row
    ``b`` from graph ``b``'s own generator, drawn in place -- what
    ``select`` draws for the graph alone. A graph with no generator (its
    budget spent) draws nothing; its row stays 1.0."""
    uniforms = torch.ones(shape, dtype=torch.float32, device=device)
    for row, gen in zip(uniforms, generators):
        if gen is not None:
            row.uniform_(generator=gen)
    return uniforms
