"""Benchmark PGM generators (paper SS III-C, SS IV-C, SS IV-E), numpy-built.

The port of the single-graph generators of ``repro.pgm.datasets``. Each
draws its potentials with numpy exactly as the reference does, so the same
seed gives bitwise-equal arrays, and hands them to the port's builders,
which move the finished graph to ``device`` (default ``"cuda"``).

Ising grids: N x N binary variables. Unary psi_i ~ U[0,1] (per-state
sample). Pairwise: psi_ij = e^{lambda C} if x_i == x_j else e^{-lambda C},
with lambda ~ U[-0.5, 0.5] per edge; C controls difficulty (paper uses C in
{2, 2.5, 3}).

Chains: N binary variables in a path; same potential sampling, C = 10 in
the paper -- BP is exact there, which exposes scheduler *overhead*.

Protein-like graphs (SS IV-E): structurally matched stand-ins for the
side-chain prediction MRFs -- random geometric contact graphs with 2..81
states per vertex and dense positive pairwise tables.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import PGM, build_pgm, build_pgm_uniform

__all__ = ["chain_graph", "ising_grid", "ising_grid_fast",
           "protein_like_graph", "small_ising"]


def _grid_edges(n: int) -> np.ndarray:
    """Vectorized N x N grid edge list."""
    idx = np.arange(n * n).reshape(n, n)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([horiz, vert], axis=0)


def _loop_grid_edges(n: int) -> np.ndarray:
    """N x N grid edges in the reference's per-vertex loop order."""
    v = lambda r, c: r * n + c
    edges = []
    for r in range(n):
        for c in range(n):
            if c + 1 < n:
                edges.append((v(r, c), v(r, c + 1)))
            if r + 1 < n:
                edges.append((v(r, c), v(r + 1, c)))
    return np.array(edges, dtype=np.int64)


def _ising_potentials(rng: np.random.Generator, n_edges: int, C: float
                      ) -> List[np.ndarray]:
    lam = rng.uniform(-0.5, 0.5, size=n_edges)
    agree = np.exp(lam * C)
    disagree = np.exp(-lam * C)
    return [np.array([[a, d], [d, a]]) for a, d in zip(agree, disagree)]


def ising_grid_fast(n: int, C: float, seed: int = 0, *,
                    device="cuda") -> PGM:
    """Vectorized N x N Ising grid (the same distribution family as
    ``ising_grid``, a different edge order and draw sequence); the builder
    for large grids, where a per-edge Python loop is prohibitive."""
    rng = np.random.default_rng(seed)
    edges = _grid_edges(n)
    unary = rng.uniform(1e-3, 1.0, size=(n * n, 2))
    lam = rng.uniform(-0.5, 0.5, size=len(edges))
    agree, disagree = np.exp(lam * C), np.exp(-lam * C)
    pairwise = np.empty((len(edges), 2, 2))
    pairwise[:, 0, 0] = pairwise[:, 1, 1] = agree
    pairwise[:, 0, 1] = pairwise[:, 1, 0] = disagree
    return build_pgm_uniform(n * n, edges, unary, pairwise, device=device)


def ising_grid(n: int, C: float, seed: int = 0, *, device="cuda") -> PGM:
    """N x N Ising grid, paper SS III-C: uniform [0,1] unaries and
    agree/disagree pairwise tables at coupling strength ``C``."""
    rng = np.random.default_rng(seed)
    edges = _loop_grid_edges(n)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n * n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    return build_pgm(n * n, edges, unary, pairwise, device=device)


def small_ising(n: int = 10, C: float = 2.0, seed: int = 0, *,
                device="cuda") -> Tuple[PGM, int, np.ndarray, list, list]:
    """Ising grid plus raw ``(n_vertices, edges, unary, pairwise)`` for an
    exact oracle (paper Fig 5 uses 10x10, C=2)."""
    rng = np.random.default_rng(seed)
    edges = _loop_grid_edges(n)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n * n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    pgm = build_pgm(n * n, edges, unary, pairwise, device=device)
    return pgm, n * n, edges, unary, pairwise


def chain_graph(n: int, C: float = 10.0, seed: int = 0, *,
                device="cuda") -> PGM:
    """Length-n binary chain, paper SS III-C (n = 100000, C = 10)."""
    rng = np.random.default_rng(seed)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    return build_pgm(n, edges, unary, pairwise, device=device)


def protein_like_graph(n_vertices: int = 120, seed: int = 0, *,
                       max_states: int = 81, coupling: float = 2.0,
                       radius: float = 0.14, device="cuda") -> PGM:
    """Irregular mixed-cardinality MRF shaped like side-chain prediction
    problems (paper SS IV-E): spatial contact graph, 2..max_states states,
    pairwise tables exp(coupling * U(-1, 1))."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, size=(n_vertices, 2))
    edges = []
    for i in range(n_vertices):
        for j in range(i + 1, n_vertices):
            if np.linalg.norm(pos[i] - pos[j]) < radius:
                edges.append((i, j))
    # ensure connectivity along a backbone (residue chain)
    for i in range(n_vertices - 1):
        if (i, i + 1) not in edges:
            edges.append((i, i + 1))
    edges = np.array(sorted(set(map(tuple, edges))), dtype=np.int64)
    # state counts: skewed toward small, ranging 2..max_states (paper: 2..81)
    n_states = np.clip(
        rng.geometric(p=0.08, size=n_vertices) + 1, 2, max_states)
    unary = [rng.uniform(1e-2, 1.0, size=int(s)) for s in n_states]
    pairwise = []
    for (i, j) in edges:
        si, sj = int(n_states[i]), int(n_states[j])
        pairwise.append(np.exp(coupling * rng.uniform(-1.0, 1.0, (si, sj))))
    return build_pgm(n_vertices, edges, unary, pairwise, device=device)
