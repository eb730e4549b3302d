"""Plain sum-product belief propagation on a pairwise MRF.

The benchmark's reference for every configuration that
``perfbench.inputs`` describes as ``(n_vertices, edges, unary, pairwise)``.
It imports torch and numpy only and works every derived array (log
potentials, the per-vertex sums, the excluded reverse message) out again
from the raw inputs.

Messages are in log space and normalised (their exps sum to one). The
layout read and written here is the system's documented output layout:
undirected edge ``k = (i, j)`` is directed edge ``2k`` (i -> j, a message
over x_j) followed by ``2k + 1`` (j -> i, over x_i); rows past ``2 E_und``
are padding and are not read.

- ``judge`` holds a finished answer against the BP equations in float64:
  the widest L-inf residual of one BP update of the answer's own messages
  (the paper's Eq. 4; zero at an exact fixed point), and the widest gap
  between the answer's marginals and those that its messages give.
- ``solve`` runs randomized BP (the paper's RnBP: eps filter, then a
  Bernoulli(p) keep with the two-mode p) in any dtype. It stands in the
  system's place for the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: undirected edges per block of the float64 judge
BLOCK_EDGES = 1 << 18


class Graph:
    """The raw inputs on ``device`` in ``dtype``: edge ends, log unaries
    (V, S) and log pairwise tables (E_und, S, S) ``[x_i, x_j]`` (an
    expanded view of one table when every edge shares it)."""

    def __init__(self, inputs: dict, device, dtype):
        edges = torch.as_tensor(np.asarray(inputs["edges"]), device=device)
        self.src, self.dst = edges[:, 0].long(), edges[:, 1].long()
        self.n_vertices = int(inputs["n_vertices"])
        self.n_edges = int(edges.shape[0])
        self.log_unary = torch.log(torch.as_tensor(
            np.asarray(inputs["unary"], dtype=np.float64))).to(device, dtype)
        self.n_states = int(self.log_unary.shape[1])
        pw = inputs["pairwise"]
        if pw.strides[0] == 0:      # one table shared by every edge
            table = torch.log(torch.as_tensor(np.array(pw[0], np.float64)))
            self.log_pair = table.to(device, dtype).expand(
                self.n_edges, self.n_states, self.n_states)
        else:
            self.log_pair = torch.log(torch.as_tensor(
                np.asarray(pw, np.float64))).to(device, dtype)

    def vertex_sums(self, fwd: torch.Tensor, bwd: torch.Tensor):
        """(V, S) sum of each vertex's incoming log-messages."""
        vsum = torch.zeros_like(self.log_unary)
        vsum.index_add_(0, self.dst, fwd)
        vsum.index_add_(0, self.src, bwd)
        return vsum

    def candidates(self, lo: int, hi: int, vsum, fwd, bwd):
        """Normalised BP updates of the directed edges of undirected edges
        ``[lo, hi)``: ``(i -> j over x_j, j -> i over x_i)``."""
        i, j = self.src[lo:hi], self.dst[lo:hi]
        lp = self.log_pair[lo:hi]
        pre_f = self.log_unary[i] + vsum[i] - bwd[lo:hi]     # over x_i
        pre_b = self.log_unary[j] + vsum[j] - fwd[lo:hi]     # over x_j
        cand_f = torch.logsumexp(lp + pre_f[:, :, None], dim=1)
        cand_b = torch.logsumexp(lp + pre_b[:, None, :], dim=2)
        return (cand_f - torch.logsumexp(cand_f, dim=1, keepdim=True),
                cand_b - torch.logsumexp(cand_b, dim=1, keepdim=True))

    def beliefs(self, vsum) -> torch.Tensor:
        """(V, S) normalised log-marginals."""
        b = self.log_unary + vsum
        return b - torch.logsumexp(b, dim=1, keepdim=True)

    def split(self, logm: torch.Tensor):
        """``(fwd, bwd)`` (E_und, S) each, from messages in the output
        layout, in this graph's dtype and device."""
        e, s = self.n_edges, self.n_states
        m = logm[:2 * e, :s].to(self.log_unary.device, self.log_unary.dtype)
        m = m.reshape(e, 2, s)
        return m[:, 0], m[:, 1]


def judge(graph: Graph, logm: torch.Tensor, beliefs: torch.Tensor) -> dict:
    """The numbers of one answer, computed in ``graph``'s dtype (float64
    for the check): ``fixed_point_resid``, the widest L-inf residual of a
    BP update of the answer's messages, and ``belief_gap``, the widest gap
    between the answer's marginals and those of its messages, in
    probability."""
    fwd, bwd = graph.split(logm)
    vsum = graph.vertex_sums(fwd, bwd)
    resid = torch.zeros((), dtype=vsum.dtype, device=vsum.device)
    for lo in range(0, graph.n_edges, BLOCK_EDGES):
        hi = min(lo + BLOCK_EDGES, graph.n_edges)
        cand_f, cand_b = graph.candidates(lo, hi, vsum, fwd, bwd)
        resid = torch.maximum(resid, (cand_f - fwd[lo:hi]).abs().amax())
        resid = torch.maximum(resid, (cand_b - bwd[lo:hi]).abs().amax())
    ref = graph.beliefs(vsum).exp()
    got = beliefs[:graph.n_vertices, :graph.n_states].to(ref).exp()
    gap = (got - ref).abs().amax()      # a NaN reads NaN: no limit passes
    return dict(fixed_point_resid=float(resid), belief_gap=float(gap))


def solve(graph: Graph, *, eps: float, max_rounds: int, low_p: float,
          high_p: float, ratio_threshold: float = 0.9,
          generator: torch.Generator) -> dict:
    """Randomized BP in ``graph``'s dtype from uniform messages: each round
    updates every directed edge, stops when no residual reaches ``eps``,
    and otherwise commits each unconverged edge with probability ``p``
    (``low_p`` when the unconverged count fell by less than a tenth since
    the last round, else ``high_p``). Returns the answer in the output
    layout: ``logm`` (2 E_und, S), ``beliefs`` (V, S), ``rounds``,
    ``converged``."""
    e, s = graph.n_edges, graph.n_states
    dev, dt = graph.log_unary.device, graph.log_unary.dtype
    fwd = torch.full((e, s), -math.log(s), dtype=dt, device=dev)
    bwd = fwd.clone()
    prev, converged, rounds = float(2 * e), False, 0
    for rounds in range(max_rounds):
        vsum = graph.vertex_sums(fwd, bwd)
        cand_f, cand_b = graph.candidates(0, e, vsum, fwd, bwd)
        open_f = (cand_f - fwd).abs().amax(dim=1) >= eps
        open_b = (cand_b - bwd).abs().amax(dim=1) >= eps
        count = int(open_f.sum()) + int(open_b.sum())
        if count == 0:
            converged = True
            break
        p = low_p if count / max(prev, 1.0) > ratio_threshold else high_p
        draw = torch.rand((e, 2), generator=generator, device=dev)
        fwd = torch.where((open_f & (draw[:, 0] < p))[:, None], cand_f, fwd)
        bwd = torch.where((open_b & (draw[:, 1] < p))[:, None], cand_b, bwd)
        prev = float(count)
    else:
        rounds = max_rounds
    vsum = graph.vertex_sums(fwd, bwd)
    return dict(logm=torch.stack([fwd, bwd], dim=1).reshape(2 * e, s),
                beliefs=graph.beliefs(vsum), rounds=rounds,
                converged=converged)
