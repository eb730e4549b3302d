"""Serial Residual BP (the paper's SRBP baseline, SS III-B).

The port of ``repro.core.serial``. The paper implements SRBP with a Boost
Fibonacci heap on a Xeon; here, as in the reference, it is a host-side
numpy implementation with a lazy-deletion binary heap. One message -- the
global max-residual one -- is updated per step; residuals of the
out-edges of the destination vertex are refreshed incrementally.

This is the *speed baseline* for Tables I-III and the *quality baseline*
for Fig 5 (KL parity). It is host-serial by design: a graph on the GPU is
read to the host once, at the start, and every update runs on the CPU.
It is the one path of the port that runs on the CPU by its nature; the
arithmetic below is the reference's, so given the same graph arrays the
updates and beliefs are the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.graph import PGM

__all__ = ["SRBPResult", "run_srbp", "srbp_run"]

NEG_INF = -1.0e30


@dataclasses.dataclass
class SRBPResult:
    """Host-serial RBP baseline output: ``beliefs (V, S) float64`` log-
    marginals, the count of single-message ``updates`` executed, and
    ``converged`` -- True iff the global max residual fell below eps before
    the update/time budget ran out."""

    beliefs: np.ndarray
    updates: int
    converged: bool
    wall_time_s: float
    max_residual: float


class _SerialBP:
    def __init__(self, pgm: PGM):
        host = pgm.to_numpy()           # the graph's one read to the host
        self.src = host["edge_src"]
        self.dst = host["edge_dst"]
        self.rev = host["edge_rev"]
        self.emask = host["edge_mask"]
        self.log_psi_e = host["log_psi_e"].astype(np.float64)
        self.log_psi_v = host["log_psi_v"].astype(np.float64)
        self.smask = host["state_mask"]
        self.n_states = host["n_states"]
        self.V = pgm.n_vertices
        self.real_edges = np.nonzero(self.emask)[0]
        # out_edges[v] = directed edges with src == v
        self.out_edges: List[np.ndarray] = [
            np.empty(0, np.int64)] * self.V
        order = np.argsort(self.src[self.real_edges], kind="stable")
        sorted_e = self.real_edges[order]
        srcs = self.src[sorted_e]
        bounds = np.searchsorted(srcs, np.arange(self.V + 1))
        for v in range(self.V):
            self.out_edges[v] = sorted_e[bounds[v]:bounds[v + 1]]
        # uniform init
        self.logm = np.where(
            self.smask[self.dst],
            -np.log(self.n_states[self.dst].astype(np.float64))[:, None],
            NEG_INF)
        self.vsum = np.zeros((self.V, self.logm.shape[1]))
        np.add.at(self.vsum, self.dst[self.real_edges],
                  self.logm[self.real_edges])

    def candidate(self, e: int) -> np.ndarray:
        i = self.src[e]
        pre = (self.log_psi_v[i] + self.vsum[i] - self.logm[self.rev[e]])
        pre = np.where(self.smask[i], pre, NEG_INF)
        scores = self.log_psi_e[e] + pre[:, None]
        m = np.max(scores, axis=0)
        m = np.maximum(m, NEG_INF)
        cand = m + np.log(np.maximum(
            np.sum(np.exp(scores - m[None, :]), axis=0), 1e-300))
        dmask = self.smask[self.dst[e]]
        z_m = np.max(np.where(dmask, cand, NEG_INF))
        z = z_m + np.log(np.sum(np.where(dmask, np.exp(cand - z_m), 0.0)))
        return np.where(dmask, cand - z, NEG_INF)

    def residual(self, e: int, cand: Optional[np.ndarray] = None) -> float:
        if cand is None:
            cand = self.candidate(e)
        dmask = self.smask[self.dst[e]]
        return float(np.max(np.where(dmask, np.abs(cand - self.logm[e]), 0.0)))

    def commit(self, e: int, cand: np.ndarray) -> None:
        j = self.dst[e]
        self.vsum[j] = self.vsum[j] - self.logm[e] + cand
        self.logm[e] = cand

    def beliefs(self) -> np.ndarray:
        b = self.log_psi_v + self.vsum
        b = np.where(self.smask, b, NEG_INF)
        m = np.max(b, axis=1, keepdims=True)
        z = m + np.log(np.sum(np.exp(b - m), axis=1, keepdims=True))
        return np.where(self.smask, b - z, NEG_INF)


def srbp_run(pgm: PGM, *, eps: float = 1e-3,
             max_updates: int = 10_000_000,
             time_limit_s: float = 90.0) -> SRBPResult:
    """Greedy max-residual serial BP (paper gives SRBP 90 s before declaring
    non-convergence -- same default here). Reached through the unified API
    as ``BPEngine(BPConfig(scheduler="srbp", scheduler_kwargs={...})).run``.
    """
    bp = _SerialBP(pgm)
    stamp = np.zeros(bp.logm.shape[0], np.int64)
    heap: list = []
    for e in bp.real_edges:
        r = bp.residual(int(e))
        heapq.heappush(heap, (-r, int(stamp[e]), int(e)))
    t0 = time.perf_counter()
    updates = 0
    max_r = np.inf
    converged = False
    while updates < max_updates:
        if updates % 256 == 0 and time.perf_counter() - t0 > time_limit_s:
            break
        # pop until fresh
        while heap and heap[0][1] != stamp[heap[0][2]]:
            heapq.heappop(heap)
        if not heap:
            converged = True
            max_r = 0.0
            break
        neg_r, _, e = heap[0]
        max_r = -neg_r
        if max_r < eps:
            converged = True
            break
        heapq.heappop(heap)
        cand = bp.candidate(e)
        bp.commit(e, cand)
        updates += 1
        stamp[e] += 1
        heapq.heappush(heap, (0.0, int(stamp[e]), e))  # own residual now 0
        j = int(bp.dst[e])
        for e2 in bp.out_edges[j]:
            e2 = int(e2)
            r2 = bp.residual(e2)
            stamp[e2] += 1
            heapq.heappush(heap, (-r2, int(stamp[e2]), e2))
    return SRBPResult(beliefs=bp.beliefs(), updates=updates,
                      converged=converged,
                      wall_time_s=time.perf_counter() - t0,
                      max_residual=float(max_r))


def run_srbp(pgm: PGM, *, eps: float = 1e-3,
             max_updates: int = 10_000_000,
             time_limit_s: float = 90.0) -> SRBPResult:
    """Deprecated wrapper: use
    ``BPEngine(BPConfig(scheduler="srbp", eps=...,
    scheduler_kwargs={"time_limit_s": ...})).run(pgm)``."""
    import warnings
    warnings.warn(
        "run_srbp is deprecated: use repro_torch.core.BPEngine with "
        "BPConfig(scheduler='srbp')", DeprecationWarning, stacklevel=2)
    return srbp_run(pgm, eps=eps, max_updates=max_updates,
                    time_limit_s=time_limit_s)
