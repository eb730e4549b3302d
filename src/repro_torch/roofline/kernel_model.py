"""Hand cost model of the fused message update, and the bound it gives.

The port of ``repro.roofline.kernel_model``'s ``fused_update_cost`` and
``predicted_intensity``. The fused kernels (``fused_update_e``,
``fused_update_t``) read each input once and write each output once -- the
pairwise table, the prelude and the old messages in, the new messages and
the residual out, plus the 1-byte destination-state mask. Per edge of S
states at ``dtype_bytes`` b:

    bytes = (S^2 + 3*S + 1) * b  +  S

Flops are the reference's hand count, one flop per output element per
arithmetic op:

    sum-product:  5*S^2 + 24*S + 6
    max-product:  2*S^2 + 14*S + 1

The port's kernels pad nothing (no power-of-two states, no block-multiple
edges), so the reference's ``padded=True`` and ``gpu_padded_shape`` have no
counterpart: these are the logical costs, which are the launched ones.
``edge_prelude_cost`` is the same contract for the edge-prelude kernel.
``bound_ms`` turns a cost into the least time a card could take for it,
from the card's published peaks (``CARD_PEAKS``). ``round_cost`` counts
one whole engine round with ``op_cost``, the kernel charged by this model.
"""

from __future__ import annotations

import torch

from repro_torch.roofline.op_cost import Cost, op_cost

__all__ = ["Cost", "CARD_PEAKS", "card_peaks", "fused_update_cost",
           "edge_prelude_cost", "predicted_intensity", "bound_ms",
           "engine_round", "round_cost"]

_FLOPS_PER_EDGE = {
    # semiring -> (S^2 coefficient, S coefficient, constant)
    "sum": (5.0, 24.0, 6.0),
    "max": (2.0, 14.0, 1.0),
}

#: Published peaks (NVIDIA data sheets): device memory bytes/s and float32
#: (non-tensor-core) FLOP/s, by a substring of ``torch.cuda.
#: get_device_name()``; the first match wins.
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))


def card_peaks(name: str):
    """``(bytes/s, float32 flop/s)`` of the card named ``name``."""
    for key, bw, f32 in CARD_PEAKS:
        if key in name:
            return bw, f32
    raise RuntimeError(f"no published peaks for {name!r}; add it to "
                       "CARD_PEAKS")


def fused_update_cost(n_edges: int, n_states: int, *, dtype_bytes: int = 4,
                      semiring: str = "sum") -> Cost:
    """Cost of one fused update over ``n_edges`` edges of ``n_states``
    states: each input read once, each output written once."""
    if semiring not in _FLOPS_PER_EDGE:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         f"expected one of {sorted(_FLOPS_PER_EDGE)}")
    e, s = int(n_edges), int(n_states)
    a, b, c = _FLOPS_PER_EDGE[semiring]
    return Cost(float(e * (a * s * s + b * s + c)),
                float(e * ((s * s + 3 * s + 1) * dtype_bytes + s)))


def edge_prelude_cost(n_edges: int, n_vertices: int, n_states: int,
                      in_width: int) -> Cost:
    """Cost of one edge-prelude kernel (``kernels.edge_prelude``) over E
    edges and V vertices of S states with an in-edge table D wide: the
    operands the vertex walk reads, once each -- the messages (E, S) f32,
    ``log_psi_v`` (V, S) f32, ``state_mask`` (V, S) bool, ``in_edges``
    (V, D) i32, ``in_mask`` (V, D) bool, ``edge_rev`` (E,) i32,
    ``edge_mask`` (E,) bool -- and ``pre`` (E, S) f32 written once.
    ``edge_src`` is read only for padded edges, which real graphs do not
    have, and is not charged; nor are a padded edge's extra reads of its
    source's rows. Flops, one per output element per op: the fold's D
    selects and D - 1 adds and the potential's add per vertex state, a
    subtract and a select per edge state."""
    e, v, s, d = int(n_edges), int(n_vertices), int(n_states), int(in_width)
    return Cost(float(2 * s * (v * d + e)),
                float(e * (8 * s + 5) + v * (5 * s + 5 * d)))


def predicted_intensity(n_states: int, *, dtype_bytes: int = 4,
                        semiring: str = "sum") -> float:
    """Model arithmetic intensity (flops/byte) of the fused update; the edge
    count cancels. It stays below 1.7 flop/byte at every state count, far
    under an H100's float32 ridge point (67e12 / 3.35e12 = 20 flop/byte
    without tensor cores): the update is memory-bound everywhere."""
    return fused_update_cost(1, n_states, dtype_bytes=dtype_bytes,
                             semiring=semiring).intensity


def bound_ms(cost: Cost, bw: float, f32: float):
    """``(ms, "bytes" | "operations")``: the larger of the cost's bytes
    over the memory rate ``bw`` and its flops over the float32 peak
    ``f32``, and which of the two it is."""
    t_bytes, t_ops = cost.bytes / bw * 1e3, cost.flops / f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def engine_round(pgm, scheduler, update_fn, *, eps: float = 1e-3,
                 rng: torch.Generator | None = None):
    """``(one_round, (logm, sstate))``: one engine round as the engine's
    step runs it -- the update, the residual gate, ``scheduler.select``
    and ``apply_frontier`` -- and its arguments at the uniform start. A
    rank-resident graph (``dist.shard_pgm``) starts from its slice of the
    messages and commits its slice of the frontier. Stochastic schedulers
    draw from ``rng`` (one seeded 0 on the graph's device by default)."""
    from repro_torch.core import messages as M

    if getattr(pgm, "rank_resident", False):
        logm = pgm.init_messages()
    else:
        logm = M.init_messages(pgm)
    gen = rng if rng is not None else torch.Generator(
        device=pgm.edge_mask.device).manual_seed(0)
    lo, hi = getattr(pgm, "span", (0, None))

    def one_round(logm, sstate):
        cand, r = update_fn(pgm, logm)
        unconverged = ((r >= eps) & pgm.edge_mask).sum().to(torch.int32)
        frontier, sstate = scheduler.select(pgm, r, eps, gen, sstate,
                                            unconverged)
        return M.apply_frontier(logm, cand, frontier[lo:hi]), sstate

    return one_round, (logm, scheduler.init(pgm))


def round_cost(pgm, scheduler, update_fn, *, eps: float = 1e-3,
               rng: torch.Generator | None = None) -> Cost:
    """``op_cost`` of ONE engine round (``engine_round``) for a scheduler
    instance and an update backend (``update_fn(pgm, logm)``). The fused
    kernel is charged by ``fused_update_cost``; the rest is what the
    scheduler adds (top-k, bisection, draws). ``pgm`` may hold fake
    tensors: then nothing runs."""
    one_round, args = engine_round(pgm, scheduler, update_fn, eps=eps,
                                   rng=rng)
    return op_cost(one_round, *args)
