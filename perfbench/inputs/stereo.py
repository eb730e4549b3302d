"""Synthetic stereo frames with the classic truncated-linear energy.

A slanted background plane of disparities with a raised foreground
rectangle; the observation adds Gaussian noise and a share of uniform
outliers. Unaries are ``exp(-lam_data * min(|d - obs|, trunc_data))`` and
every edge shares ``exp(-lam_smooth * min(|d_i - d_j|, trunc_smooth))``.
``draw`` is a frozen copy of the arithmetic of ``repro_torch.pgm.
stereo_mrf``: the same seed gives the same arrays. The pairwise table is
returned as a read-only broadcast view, one (S, S) table for every edge.

How many rounds a bucket needs moves with its frames' noise, so a pool
drawn afresh from each run's seed would make the runs' work differ more
than two runs of one seed do. With ``catalog`` (a list of draw seeds) the
pool's frame ``slot`` is the catalog's draw under one of 8 symmetries
that keep BP's work -- flipped up-down, left-right, and the disparities
reversed (d -> n_disp - 1 - d, which the truncated-linear terms do not
tell apart) -- which the run's seed picks.
"""

from __future__ import annotations

import numpy as np

from perfbench.inputs.ising_grid import grid_edges

#: up-down and left-right flips, times the disparities reversed
N_SYMMETRIES = 8


def draw(params: dict, seed: int) -> tuple:
    """``(unary (H*W, n_disp), pairwise)`` of the draw ``seed``."""
    height, width = int(params["height"]), int(params["width"])
    n_disp = int(params["n_disp"])
    rng = np.random.default_rng(seed)
    _, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    truth = np.clip(np.round((cc / max(width - 1, 1)) * (n_disp // 2)),
                    0, n_disp - 1).astype(int)
    fh, fw = max(1, height // 3), max(1, width // 3)
    r0, c0 = height // 4, width // 4
    truth[r0:r0 + fh, c0:c0 + fw] = max(n_disp - 2, 0)
    obs = truth + rng.normal(0.0, params["noise"], truth.shape)
    outliers = rng.random(truth.shape) < params["outlier_frac"]
    obs[outliers] = rng.integers(0, n_disp, int(outliers.sum()))
    d = np.arange(n_disp)
    unary = np.exp(-params["lam_data"] * np.minimum(
        np.abs(obs.reshape(-1, 1) - d), params["trunc_data"]))
    smooth = np.exp(-params["lam_smooth"] * np.minimum(
        np.abs(d[:, None] - d[None, :]), params["trunc_smooth"]))
    n_edges = (height - 1) * width + height * (width - 1)
    return unary, np.broadcast_to(smooth, (n_edges, n_disp, n_disp))


def symmetric(height: int, width: int, unary: np.ndarray, sym: int):
    """``unary`` of the same frame under symmetry ``sym`` (0 is the
    identity): bit 0 flips up-down, bit 1 left-right, bit 2 reverses the
    disparities."""
    old = np.arange(height * width).reshape(height, width)
    if sym & 1:
        old = old[::-1]
    if sym & 2:
        old = old[:, ::-1]
    unary = unary[old.ravel()]
    if sym & 4:
        unary = unary[:, ::-1]
    return np.ascontiguousarray(unary)


def make(params: dict, seed: int, slot: int = 0) -> dict:
    height, width = int(params["height"]), int(params["width"])
    catalog = params.get("catalog")
    if catalog is None:
        unary, pairwise = draw(params, seed)
    else:
        unary, pairwise = draw(params, catalog[slot % len(catalog)])
        unary = symmetric(height, width, unary, seed % N_SYMMETRIES)
    return dict(n_vertices=height * width, edges=grid_edges(height, width),
                unary=unary, pairwise=pairwise)
