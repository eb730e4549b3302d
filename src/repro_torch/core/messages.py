"""Log-space sum-product message math: the port's plain torch path.

The port of ``repro.core.messages``. Per round, vectorized over *all*
directed edges (the scheduler masks which results commit):

    vsum[i]   = sum over incoming edges e'=(k->i) of logm[e']
    pre[e]    = log_psi_v[src] + vsum[src] - logm[rev(e)]            (exclude j->i)
    cand[e,j] = LSE_{x_i}( log_psi_e[e, x_i, x_j] + pre[e, x_i] )    (hot spot)

``cand`` is then normalized (LSE over valid dst states == 0). The hot spot,
fused with the normalize and the residual, is the hand-written kernel
behind ``repro_torch.kernels.triton_update``; this module is its oracle and
the ``"ref"`` backend.

Residual (paper Eq. 4): r(m) = || f_BP(m) - m ||_inf over valid states.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import NEG_INF, PGM

__all__ = ["masked_logsumexp", "init_messages", "fold_in_edges",
           "fold_in_edges_from", "vertex_logprod", "normalize_beliefs",
           "edge_prelude", "propagate_ref", "normalize_messages",
           "compute_candidates", "normalize_and_residual",
           "residuals", "beliefs", "ref_update", "propagate_max",
           "max_product_update", "map_assignment", "apply_frontier"]


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """LSE over ``dim`` counting only ``mask`` entries; NEG_INF-safe (an
    all-masked row gives a finite ~NEG_INF value, never -inf or NaN)."""
    x = torch.where(mask, x, NEG_INF)
    m = torch.clamp(x.amax(dim=dim, keepdim=True), min=NEG_INF)
    s = torch.where(mask, torch.exp(x - m), 0.0).sum(dim=dim)
    return m.squeeze(dim) + torch.log(torch.clamp(s, min=1e-38))


def init_messages(pgm: PGM, lo: int = 0, hi: int | None = None
                  ) -> torch.Tensor:
    """(E, S) uniform messages over the *destination* vertex's valid
    states, NEG_INF elsewhere; rows ``[lo, hi)`` of them when given (a
    rank's slice, ``repro_torch.dist``)."""
    dst = pgm.edge_dst[lo:hi]
    n_dst = pgm.n_states[dst].to(torch.float32)
    return torch.where(pgm.state_mask[dst], -torch.log(n_dst)[:, None],
                       NEG_INF)


def vertex_logprod(pgm: PGM, logm: torch.Tensor) -> torch.Tensor:
    """(V, S) sum of incoming log-messages per vertex (the paper's
    per-vertex message product, in log space).

    Folds the incoming-edge table column by column, left to right, so every
    vertex sums its in-edges in ascending edge order on every device and in
    every run -- no float atomics. Padded edges are not in the table, so the
    dummy and padding vertices sum to 0.
    """
    return fold_in_edges(pgm.in_edges, pgm.in_mask, logm)


def fold_in_edges(in_edges: torch.Tensor, in_mask: torch.Tensor,
                  logm: torch.Tensor) -> torch.Tensor:
    """(R, S) row sums of ``logm[in_edges]`` over the ``in_mask`` entries
    of an (R, D) in-edge table, folded column by column, left to right.
    ``vertex_logprod`` runs it on the graph's table; the multi-device paths
    (``repro_torch.dist``) run it on tables restricted to a rank's edges, so
    a vertex adds its in-edges in the same order on every path."""
    gathered = torch.where(in_mask[:, :, None], logm[in_edges], 0.0)
    acc = gathered[:, 0]
    for d in range(1, gathered.shape[1]):
        acc = acc + gathered[:, d]
    return acc


def fold_in_edges_from(acc: torch.Tensor, in_edges: torch.Tensor,
                       in_mask: torch.Tensor, in_first: torch.Tensor,
                       logm: torch.Tensor) -> torch.Tensor:
    """``fold_in_edges`` continued from a running (R, S) table ``acc``:
    column by column, left to right, each ``in_mask`` entry of the (R, D)
    table is added to its row, except that an entry flagged ``in_first``
    (its row's first in-edge in the whole graph) replaces the row, as
    ``fold_in_edges`` starts from its first column. A rank of the sharded
    backend runs it on its own edges, continuing the previous rank's table
    (``repro_torch.dist``), so the chain over the ranks performs exactly
    ``fold_in_edges``' additions in its order; ``fold_in_edges`` then adds
    0.0 for each empty column, which only turns -0.0 into 0.0 and is the
    last rank's to repeat."""
    for d in range(in_edges.shape[1]):
        e = logm[in_edges[:, d]]
        acc = torch.where(in_mask[:, d, None], torch.where(
            in_first[:, d, None], e, acc + e), acc)
    return acc


def edge_prelude(pgm: PGM, logm: torch.Tensor,
                 vsum: torch.Tensor | None = None) -> torch.Tensor:
    """(E, S) per-edge source-side belief excluding the reverse message."""
    if vsum is None:
        vsum = vertex_logprod(pgm, logm)
    src = pgm.edge_src
    pre = pgm.log_psi_v[src] + vsum[src] - logm[pgm.edge_rev]
    return torch.where(pgm.state_mask[src], pre, NEG_INF)


def propagate_ref(log_psi_e: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    """The LSE hot spot: cand[e, xj] = LSE_xi(log_psi_e[e, xi, xj] +
    pre[e, xi]). Not normalized, not masked on dst."""
    scores = log_psi_e + pre[:, :, None]                     # (E, S, S)
    m = torch.clamp(scores.amax(dim=1, keepdim=True), min=NEG_INF)
    s = torch.exp(scores - m).sum(dim=1)
    return m.squeeze(1) + torch.log(torch.clamp(s, min=1e-38))


def normalize_messages(pgm: PGM, cand: torch.Tensor) -> torch.Tensor:
    """Normalize (LSE over valid dst states -> 0) and mask invalid states."""
    dst_mask = pgm.state_mask[pgm.edge_dst]
    z = masked_logsumexp(cand, dst_mask, dim=1)
    return torch.where(dst_mask, cand - z[:, None], NEG_INF)


def compute_candidates(pgm: PGM, logm: torch.Tensor,
                       propagate=propagate_ref) -> torch.Tensor:
    """One full candidate-message pass f_BP(m) for every directed edge."""
    pre = edge_prelude(pgm, logm)
    return normalize_messages(pgm, propagate(pgm.log_psi_e, pre))


def normalize_and_residual(cand: torch.Tensor, logm: torch.Tensor,
                           dst_mask: torch.Tensor, edge_mask: torch.Tensor):
    """Normalize raw candidates (LSE over valid destination states -> 0,
    invalid states NEG_INF) and compute the (E,) L-inf residual against the
    current messages (0 on padded edges). Returns ``(cand, resid)``."""
    z = masked_logsumexp(cand, dst_mask, dim=1)
    cand = torch.where(dst_mask, cand - z[:, None], NEG_INF)
    d = torch.where(dst_mask, torch.abs(cand - logm), 0.0)
    resid = torch.where(edge_mask, d.amax(dim=1), 0.0)
    return cand, resid


def residuals(pgm: PGM, logm: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(E,) L-inf residual per directed edge; 0 on padded edges."""
    dst_mask = pgm.dst_mask != 0
    d = torch.where(dst_mask, torch.abs(cand - logm), 0.0)
    return torch.where(pgm.edge_mask, d.amax(dim=1), 0.0)


def beliefs(pgm: PGM, logm: torch.Tensor) -> torch.Tensor:
    """(V, S) normalized log-marginals (paper Eq. 3), NEG_INF at invalid
    states."""
    return normalize_beliefs(pgm.log_psi_v, pgm.state_mask,
                             vertex_logprod(pgm, logm))


def normalize_beliefs(log_psi_v: torch.Tensor, state_mask: torch.Tensor,
                      vsum: torch.Tensor) -> torch.Tensor:
    """``beliefs`` from the (V, S) per-vertex message sums ``vsum``."""
    b = log_psi_v + vsum
    z = masked_logsumexp(b, state_mask, dim=1)
    return torch.where(state_mask, b - z[:, None], NEG_INF)


def ref_update(pgm: PGM, logm: torch.Tensor):
    """One BP step, plain torch: ``(candidate messages (E, S), residuals
    (E,))``. The ``"ref"`` backend; the kernel backend matches its
    signature."""
    pre = edge_prelude(pgm, logm)
    cand = propagate_ref(pgm.log_psi_e, pre)
    return normalize_and_residual(cand, logm, pgm.dst_mask != 0,
                                  pgm.edge_mask)


# ------------------------------------------------------ max-product (MAP) --

def propagate_max(log_psi_e: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    """Max-product semiring: cand[e, xj] = max_xi(log_psi + pre)."""
    return (log_psi_e + pre[:, :, None]).amax(dim=1)


def max_product_update(pgm: PGM, logm: torch.Tensor):
    """``ref_update`` for MAP inference (max-product): messages
    renormalized to max 0 over valid states. Returns ``(cand, resid)``."""
    pre = edge_prelude(pgm, logm)
    cand = propagate_max(pgm.log_psi_e, pre)
    dst_mask = pgm.dst_mask != 0
    cand = torch.where(dst_mask, cand, NEG_INF)
    z = cand.amax(dim=1)
    cand = torch.where(dst_mask, cand - z[:, None], NEG_INF)
    return cand, residuals(pgm, logm, cand)


def map_assignment(pgm: PGM, logm: torch.Tensor) -> torch.Tensor:
    """(V,) int64 argmax decoding of max-product beliefs (first maximum on
    ties, as ``jnp.argmax``)."""
    b = pgm.log_psi_v + vertex_logprod(pgm, logm)
    b = torch.where(pgm.state_mask, b, NEG_INF)
    return torch.argmax(b, dim=1)


def apply_frontier(logm: torch.Tensor, cand: torch.Tensor,
                   frontier: torch.Tensor, damping: float = 0.0
                   ) -> torch.Tensor:
    """Commit candidate messages on frontier edges (``frontier`` (E,) for
    (E, S) messages, or (B, E) for a bucket's (B, E, S)). Optional
    geometric damping: new = (1-d)*cand + d*old, in log space."""
    if damping > 0.0:
        cand = (1.0 - damping) * cand + damping * logm
    return torch.where(frontier[..., None], cand, logm)
