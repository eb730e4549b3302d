"""The paper's Ising family (arXiv:1909.11469 SS III-C, after Elidan et al.).

An N x N grid of binary variables. Unaries are uniform on
[``unary_low``, ``unary_high``) per state; each edge draws a lambda uniform
on [``lambda_low``, ``lambda_high``) and takes ``exp(lambda C)`` where the
two ends agree and ``exp(-lambda C)`` where they differ. ``draw`` is a
frozen copy of the arithmetic of ``repro_torch.pgm.ising_grid_fast``: the
same seed gives the same arrays.

How many rounds BP needs differs several-fold from one draw of the family
to the next, so a pool drawn afresh from each run's seed would make the
runs' work differ far more than two runs of one seed do. With
``catalog`` (a list of draw seeds) the pool's graph ``slot`` is the
catalog's draw, seen under one of the 16 symmetries that keep BP's work
(the square's eight rotations and reflections, times swapping the two
states), which the run's seed picks: every run gets the same set of
graphs, laid out anew.
"""

from __future__ import annotations

import numpy as np

#: rotations and reflections of the square, times the state swap
N_SYMMETRIES = 16


def grid_edges(height: int, width: int) -> np.ndarray:
    """(E_und, 2) int64 4-neighbour edges of a row-major height x width
    grid: every horizontal edge, then every vertical one."""
    idx = np.arange(height * width).reshape(height, width)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([horiz, vert], axis=0)


def _pairwise(lam: np.ndarray, c: float) -> np.ndarray:
    agree, disagree = np.exp(lam * c), np.exp(-lam * c)
    pairwise = np.empty((len(lam), 2, 2))
    pairwise[:, 0, 0] = pairwise[:, 1, 1] = agree
    pairwise[:, 0, 1] = pairwise[:, 1, 0] = disagree
    return pairwise


def draw(params: dict, seed: int) -> tuple:
    """``(unary (N^2, 2), lambda (E_und,))`` of the draw ``seed``."""
    n = int(params["n"])
    rng = np.random.default_rng(seed)
    unary = rng.uniform(params["unary_low"], params["unary_high"],
                        size=(n * n, 2))
    lam = rng.uniform(params["lambda_low"], params["lambda_high"],
                      size=2 * n * (n - 1))
    return unary, lam


def symmetric(n: int, unary: np.ndarray, lam: np.ndarray, sym: int) -> tuple:
    """``(unary, lambda)`` of the same grid under symmetry ``sym`` (0 is
    the identity), on the canonical edge list of ``grid_edges(n, n)``."""
    old = np.arange(n * n).reshape(n, n)
    old = np.rot90(old, sym % 4)
    if (sym // 4) % 2:
        old = old.T
    old = old.ravel()                       # new vertex -> old vertex
    unary = unary[old]
    if sym // 8:
        unary = unary[:, ::-1]
    a, b = old[grid_edges(n, n)].T          # each new edge, in old ids
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    horiz = hi - lo == 1
    edge = np.where(horiz, (lo // n) * (n - 1) + lo % n, n * (n - 1) + lo)
    return np.ascontiguousarray(unary), lam[edge]


def make(params: dict, seed: int, slot: int = 0) -> dict:
    n, c = int(params["n"]), float(params["coupling"])
    catalog = params.get("catalog")
    if catalog is None:
        unary, lam = draw(params, seed)
    else:
        unary, lam = draw(params, catalog[slot % len(catalog)])
        unary, lam = symmetric(n, unary, lam, seed % N_SYMMETRIES)
    return dict(n_vertices=n * n, edges=grid_edges(n, n), unary=unary,
                pairwise=_pairwise(lam, c))
