"""Relaxed multi-queue residual BP (Aksenov, Alistarh, Korhonen 2020).

The port of ``repro.core.schedulers.rlx``. RBP's exact top-k is a
device-wide sort; the relaxed-scheduling result (arxiv 2002.11505) is that
BP does not need it: pick *approximately* the highest-residual messages --
a MultiQueue -- and the trajectory converges like exact residual BP while
the selection becomes embarrassingly parallel.

The edge axis is cut into ``Q`` equal contiguous queues (a reshape). Each
round:

1. sample a Bernoulli(``sample``) subset of queues (one ``(Q,)`` draw; the
   queue holding the current max residual is always included, so a round
   never selects nothing while unconverged),
2. inside each sampled queue admit the local top ``k = p * |E| / Q``
   residuals (threshold semantics like RBP), the per-queue k-th value
   found by a 30-step **bisection on the threshold** (count >= k), as the
   reference does, not by ``torch.topk``.

The draw comes from the engine's ``torch.Generator`` (one row per graph on
a bucket); ``select_with`` takes it as an argument, so tests feed both
packages the same uniforms and compare masks bitwise. On a bucket the
queue view is ``(B, Q, L)`` and every step runs on the trailing axes, one
set of launches for the whole bucket.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import draw_rows

__all__ = ["RLX", "queue_count", "queue_threshold", "relaxed_frontier",
           "per_queue_k"]


def queue_count(n_edges: int, queues: int) -> int:
    """Effective queue count: the largest ``q <= queues`` dividing the
    padded edge count, so the queue partition is an exact reshape. Padded
    edge counts are multiples of ``EDGE_PAD = 128``, so any power-of-two
    ``queues <= 128`` is returned unchanged for generated graphs."""
    q = max(1, min(int(queues), int(n_edges)))
    while n_edges % q:
        q -= 1
    return q


def per_queue_k(p: float, count: int, q: int, l: int) -> int:
    """``clip(round(p * count / q), 1, l)`` computed as the reference
    computes it: float32 product and quotient, rounded half to even."""
    k = np.round(np.float32(p) * np.float32(count) / np.float32(q))
    return int(np.clip(k, 1, l))


def queue_threshold(res2: torch.Tensor, k, iters: int = 30) -> torch.Tensor:
    """Per-queue k-th-largest threshold by bisection: the largest ``t`` (per
    queue, to float resolution) with ``count(res >= t) >= k``.

    ``res2`` is ``(..., Q, L)``; ``k`` a host int or a tensor broadcasting
    against the leading axes (one ``k`` per graph on a bucket). Returns
    ``(..., Q)``. Invariant: ``lo`` always satisfies the count, ``hi``
    never does."""
    hi = res2.amax(dim=-1) * (1.0 + 1e-6) + 1e-30        # count(>=hi) == 0
    lo = torch.zeros_like(hi)                           # count(>=0) == L
    if isinstance(k, torch.Tensor):
        k = k.reshape(k.shape + (1,) * (hi.dim() - k.dim()))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = (res2 >= mid[..., None]).sum(dim=-1) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def relaxed_frontier(res2: torch.Tensor, k, sample: float,
                     uniforms: torch.Tensor) -> torch.Tensor:
    """The shared relaxed selection: per-queue top-k over sampled queues.

    ``res2`` is the ``(..., Q, L)`` queue view of the masked residuals
    (zeros on non-real edges), ``uniforms`` the round's ``(..., Q)`` draw.
    Returns the ``(..., Q, L)`` bool frontier: edges at or above their
    queue's k-th residual (ties admitted) in queues kept by the draw; the
    queue holding the max residual is always kept."""
    maxq = res2.amax(dim=-1)                             # (..., Q)
    thresh = queue_threshold(res2, k)
    keep = (uniforms < sample).scatter(
        -1, maxq.argmax(dim=-1, keepdim=True), True)     # max queue always in
    # >= max(thresh, tiny): never thrash zero-residual (converged/padding)
    # edges on the last stretch -- RBP's guard, per queue.
    return (res2 >= torch.clamp(thresh, min=1e-30)[..., None]) \
        & keep[..., None]


@dataclasses.dataclass(frozen=True)
class RLX:
    """Relaxed multi-queue residual BP: per-queue top-k of a sampled queue
    subset -- approximate prioritization without a global sort.

    ``select`` cuts the edge axis into ``queues`` contiguous equal blocks,
    keeps a Bernoulli(``sample``) subset of queues (the queue holding the
    max residual always included), and admits each kept queue's local top
    ``k = p * |E| / Q`` residuals (``|E|`` the graph's own
    ``edge_count``). Draws one ``(Q,)`` uniform per round; no carried
    state. Registry spec ``"rlx"``.
    """

    queues: int = 8          # Q: relaxation degree (queues to cut edges into)
    sample: float = 0.5      # fraction of queues admitted per round
    p: float = 1.0 / 256.0   # frontier multiplier: k_per_queue = p * |E| / Q
    inner_sweeps: int = 1

    def __post_init__(self):
        if self.queues < 1:
            raise ValueError(f"queues must be >= 1, got {self.queues}")
        if not 0.0 < self.sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {self.sample}")
        if not self.p > 0.0:
            raise ValueError(f"p must be > 0, got {self.p}")

    def init(self, pgm: PGM):
        return ()

    def init_batch(self, batch):
        return ()

    def _k(self, counts, e: int, q: int):
        """Per-queue k: a host int for one graph's count, a list of ints
        for a bucket's counts."""
        if isinstance(counts, int):
            return per_queue_k(self.p, counts, q, e // q)
        return [per_queue_k(self.p, c, q, e // q) for c in counts]

    def _frontier(self, pgm: PGM, residuals, k, uniforms, state):
        """The frontier over queues in storage order (``state`` unused;
        ``rlxtree`` permutes the queues by its state)."""
        e = residuals.shape[-1]
        q = queue_count(e, self.queues)
        res2 = torch.where(pgm.edge_mask, residuals, 0.0).reshape(
            residuals.shape[:-1] + (q, e // q))
        frontier = relaxed_frontier(res2, k, self.sample, uniforms)
        return frontier.reshape(residuals.shape) & pgm.edge_mask

    def select(self, pgm: PGM, residuals: torch.Tensor, eps: float,
               generator: torch.Generator, state, unconverged: torch.Tensor):
        q = queue_count(residuals.shape[-1], self.queues)
        uniforms = torch.rand((q,), generator=generator, dtype=torch.float32,
                              device=residuals.device)
        return self.select_with(pgm, residuals, eps, uniforms, state,
                                unconverged)

    def select_batch(self, batch, residuals, eps, generators, state,
                     unconverged):
        e = residuals.shape[-1]
        q = queue_count(e, self.queues)
        k = batch.memo(("rlx_k", self.p, q), lambda: batch.per_graph(
            self._k(batch.pgm.edge_count, e, q)))
        uniforms = draw_rows((batch.size, q), generators, residuals.device)
        return self._frontier(batch.pgm, residuals, k, uniforms,
                              state), state

    def select_with(self, pgm: PGM, residuals: torch.Tensor, eps: float,
                    uniforms: torch.Tensor, state, unconverged: torch.Tensor):
        """``select`` given the round's ``(Q,)`` queue draw (``(B, Q)`` on a
        bucket's stacked ``pgm``): pure, so the same draw gives the
        reference's frontier and state bitwise."""
        e = residuals.shape[-1]
        k = self._k(pgm.edge_count, e, queue_count(e, self.queues))
        if not isinstance(k, int):
            k = torch.tensor(k, dtype=torch.int64, device=residuals.device)
        return self._frontier(pgm, residuals, k, uniforms, state), state
