"""Pairwise discrete MRF representation, as torch tensors on one device.

The port of ``repro.core.graph``: the same *static-shape, padded,
structure-of-arrays* layout with the same field names and dtypes --

- every undirected edge {i, j} becomes two *directed* edges (i->j) at an
  even index and (j->i) right after it; message ``m[e]`` lives on directed
  edge ``e`` and ``edge_rev[e]`` is the opposing edge,
- vertices may have heterogeneous state counts (protein-like graphs range
  2..81); everything is padded to ``n_states`` with masked ``NEG_INF``
  potentials,
- edge and vertex arrays are padded to multiples of ``EDGE_PAD`` and
  ``VERTEX_PAD``, and padded edges point at one dummy sink vertex.

Builders run on the host in numpy and move the finished arrays to
``device`` once. Beside the reference fields, a ``PGM`` carries two static
per-graph operands the round loop would otherwise rebuild every round:

- the **incoming-edge table** ``in_edges`` (V, D) int32 with ``in_mask``
  (V, D) bool: row ``v`` lists the real edges into ``v`` in ascending edge
  order. ``vertex_logprod`` folds it column by column, a fixed summation
  order, so the per-vertex sum is deterministic on CUDA (``index_add_``
  and ``scatter_add_`` use float atomics there and change from run to run);
- the **int8 destination-state mask** ``dst_mask = state_mask[edge_dst]``
  (E, S), the operand the fused update kernel takes.

``device`` defaults to ``"cuda"``: with no GPU, a builder called without
``device="cpu"`` raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = ["NEG_INF", "EDGE_PAD", "VERTEX_PAD", "PGM", "build_pgm",
           "build_pgm_uniform", "resolve_device"]

# Large-negative stand-in for log(0): summing ~1e2 of them in float32 stays
# far from -inf/NaN while exp() underflows to exactly 0.
NEG_INF = -1.0e30

# Edge-count padding multiple (kept from the reference so both packages
# build identical arrays) and vertex-count padding multiple.
EDGE_PAD = 128
VERTEX_PAD = 8

# The reference PGM's array fields, in order; ``from_numpy`` takes these.
_ARRAY_FIELDS = ("edge_src", "edge_dst", "edge_rev", "edge_mask", "log_psi_e",
                 "log_psi_v", "state_mask", "n_states")
_DTYPES = {"edge_src": torch.int32, "edge_dst": torch.int32,
           "edge_rev": torch.int32, "edge_mask": torch.bool,
           "log_psi_e": torch.float32, "log_psi_v": torch.float32,
           "state_mask": torch.bool, "n_states": torch.int32}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no GPU is present.

    Entry points default to ``"cuda"``; a caller that wants the CPU says
    ``device="cpu"``. A missing GPU raises rather than silently running the
    CPU path.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def _in_edge_table(edge_dst: np.ndarray, edge_mask: np.ndarray,
                   n_vertices: int):
    """(V, D) int32 incoming real edges per vertex, ascending edge id, plus
    the (V, D) bool validity mask; D = max real in-degree (>= 1)."""
    real = np.flatnonzero(edge_mask)
    dst = edge_dst[real].astype(np.int64)
    order = np.argsort(dst, kind="stable")       # stable: edge id ascending
    real, dst = real[order], dst[order]
    counts = np.bincount(dst, minlength=n_vertices)
    width = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(real.size) - starts[dst]
    table = np.zeros((n_vertices, width), dtype=np.int32)
    mask = np.zeros((n_vertices, width), dtype=bool)
    table[dst, slot] = real
    mask[dst, slot] = True
    return table, mask


@dataclasses.dataclass(frozen=True)
class PGM:
    """Padded, directed-edge MRF on one device.

    Shapes (E = padded directed-edge count, V = padded vertex count + 1
    dummy, S = padded state count, D = max real in-degree):
      edge_src, edge_dst, edge_rev : (E,)  int32
      edge_mask                    : (E,)  bool    True for real edges
      log_psi_e                    : (E, S, S) f32  [x_src, x_dst]
      log_psi_v                    : (V, S) f32     NEG_INF at invalid states
      state_mask                   : (V, S) bool
      n_states                     : (V,)  int32
      in_edges, in_mask            : (V, D) int32 / bool  incoming real edges
      dst_mask                     : (E, S) int8   state_mask[edge_dst]
    ``n_real_vertices``/``n_real_edges`` are the real (directed) counts.
    """

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_rev: torch.Tensor
    edge_mask: torch.Tensor
    log_psi_e: torch.Tensor
    log_psi_v: torch.Tensor
    state_mask: torch.Tensor
    n_states: torch.Tensor
    n_real_vertices: int
    n_real_edges: int
    in_edges: torch.Tensor
    in_mask: torch.Tensor
    dst_mask: torch.Tensor

    @property
    def n_edges(self) -> int:
        """Padded directed edge count."""
        return self.edge_src.shape[0]

    @property
    def n_vertices(self) -> int:
        """Padded vertex count (includes 1 dummy sink vertex)."""
        return self.log_psi_v.shape[0]

    @property
    def n_states_max(self) -> int:
        """Padded state count S."""
        return self.log_psi_v.shape[1]

    @property
    def device(self) -> torch.device:
        """The device every tensor of the graph lives on."""
        return self.log_psi_e.device

    def degree(self) -> torch.Tensor:
        """(V,) int64 in-degree per vertex (== out-degree; graph is
        symmetric)."""
        return self.in_mask.sum(dim=1)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], n_real_vertices: int,
                   n_real_edges: int, device="cuda") -> "PGM":
        """Build the port's ``PGM`` from the reference ``PGM``'s fields as
        numpy arrays (``{name: np.asarray(getattr(ref_pgm, name))}``; extra
        keys are ignored). This carries a graph across the two packages --
        the tests hand identical graphs to both -- and derives the static
        operands (incoming-edge table, int8 destination mask) on the host.
        """
        dev = resolve_device(device)
        host = {k: np.asarray(arrays[k]) for k in _ARRAY_FIELDS}
        in_edges, in_mask = _in_edge_table(host["edge_dst"], host["edge_mask"],
                                           host["log_psi_v"].shape[0])
        dst_mask = host["state_mask"][host["edge_dst"]].astype(np.int8)
        # torch.tensor copies: the result never aliases the caller's arrays
        tensors = {k: torch.tensor(v, dtype=_DTYPES[k], device=dev)
                   for k, v in host.items()}
        return cls(**tensors, n_real_vertices=int(n_real_vertices),
                   n_real_edges=int(n_real_edges),
                   in_edges=torch.from_numpy(in_edges).to(dev),
                   in_mask=torch.from_numpy(in_mask).to(dev),
                   dst_mask=torch.from_numpy(dst_mask).to(dev))

    def to_numpy(self) -> dict:
        """The reference fields as host numpy arrays (inverse of
        ``from_numpy``)."""
        return {k: getattr(self, k).cpu().numpy() for k in _ARRAY_FIELDS}


def build_pgm_uniform(n_vertices: int, edges: np.ndarray, unary: np.ndarray,
                      pairwise: np.ndarray, *, edge_pad: int = EDGE_PAD,
                      device="cuda") -> PGM:
    """Vectorized builder for uniform state-count graphs (Ising/chain at any
    scale). ``edges`` (E_und, 2), ``unary`` (V, S) and ``pairwise``
    (E_und, S, S) are linear-space numpy arrays; the result is bitwise the
    reference ``build_pgm_uniform``'s arrays, on ``device``."""
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    e_und = edges.shape[0]
    e_dir = 2 * e_und
    s = unary.shape[1]
    e_pad = _round_up(max(e_dir, 1), edge_pad)
    v_pad = _round_up(n_vertices + 1, VERTEX_PAD)
    dummy = n_vertices

    edge_src = np.full((e_pad,), dummy, dtype=np.int32)
    edge_dst = np.full((e_pad,), dummy, dtype=np.int32)
    edge_rev = np.arange(e_pad, dtype=np.int32)
    edge_mask = np.zeros((e_pad,), dtype=bool)
    log_psi_e = np.zeros((e_pad, s, s), dtype=np.float32)
    log_psi_v = np.full((v_pad, s), NEG_INF, dtype=np.float32)
    state_mask = np.zeros((v_pad, s), dtype=bool)
    n_states = np.full((v_pad,), 1, dtype=np.int32)

    fwd = np.arange(0, e_dir, 2)
    bwd = fwd + 1
    edge_src[fwd], edge_dst[fwd] = edges[:, 0], edges[:, 1]
    edge_src[bwd], edge_dst[bwd] = edges[:, 1], edges[:, 0]
    edge_rev[fwd], edge_rev[bwd] = bwd, fwd
    edge_mask[:e_dir] = True
    lp = np.log(pairwise.astype(np.float64)).astype(np.float32)
    log_psi_e[fwd] = lp
    log_psi_e[bwd] = np.swapaxes(lp, 1, 2)
    log_psi_v[:n_vertices] = np.log(unary.astype(np.float64))
    state_mask[:n_vertices] = True
    n_states[:n_vertices] = s
    log_psi_v[dummy:, 0] = 0.0
    state_mask[dummy:, 0] = True

    return PGM.from_numpy(dict(
        edge_src=edge_src, edge_dst=edge_dst, edge_rev=edge_rev,
        edge_mask=edge_mask, log_psi_e=log_psi_e, log_psi_v=log_psi_v,
        state_mask=state_mask, n_states=n_states),
        n_vertices, e_dir, dev)


def build_pgm(n_vertices: int, edges: np.ndarray,
              unary: Sequence[np.ndarray], pairwise: Sequence[np.ndarray], *,
              edge_pad: int = EDGE_PAD, state_pad_to: int | None = None,
              device="cuda") -> PGM:
    """Build a padded PGM from host-side numpy potentials (linear space):
    ``unary[v]`` is vertex v's (S_v,) table, ``pairwise[k]`` undirected edge
    k's (S_i, S_j) table. Potentials must be strictly positive. The arrays
    are bitwise the reference ``build_pgm``'s, moved to ``device`` once."""
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2), got {edges.shape}")
    e_und = edges.shape[0]
    e_dir = 2 * e_und

    n_states_arr = np.array([len(u) for u in unary], dtype=np.int32)
    s_max = int(n_states_arr.max()) if len(unary) else 1
    if state_pad_to is not None:
        s_max = max(s_max, state_pad_to)

    e_pad = _round_up(max(e_dir, 1), edge_pad)
    v_pad = _round_up(n_vertices + 1, VERTEX_PAD)  # +1 dummy sink vertex
    dummy = n_vertices  # padded edges point at the dummy vertex

    edge_src = np.full((e_pad,), dummy, dtype=np.int32)
    edge_dst = np.full((e_pad,), dummy, dtype=np.int32)
    edge_rev = np.arange(e_pad, dtype=np.int32)  # padded edges self-reverse
    edge_mask = np.zeros((e_pad,), dtype=bool)
    log_psi_e = np.zeros((e_pad, s_max, s_max), dtype=np.float32)
    log_psi_v = np.full((v_pad, s_max), NEG_INF, dtype=np.float32)
    state_mask = np.zeros((v_pad, s_max), dtype=bool)
    n_states = np.ones((v_pad,), dtype=np.int32)

    for v in range(n_vertices):
        s = int(n_states_arr[v])
        u = np.asarray(unary[v], dtype=np.float64)
        if u.shape != (s,) or not np.all(u > 0):
            raise ValueError(f"bad unary at vertex {v}")
        log_psi_v[v, :s] = np.log(u)
        state_mask[v, :s] = True
        n_states[v] = s
    # Dummy vertex: single valid state with psi=1 so padded edges stay inert.
    log_psi_v[dummy:, 0] = 0.0
    state_mask[dummy:, 0] = True

    for k in range(e_und):
        i, j = int(edges[k, 0]), int(edges[k, 1])
        si, sj = int(n_states_arr[i]), int(n_states_arr[j])
        p = np.asarray(pairwise[k], dtype=np.float64)
        if p.shape != (si, sj) or not np.all(p > 0):
            raise ValueError(f"bad pairwise at edge {k}")
        fwd, bwd = 2 * k, 2 * k + 1
        edge_src[fwd], edge_dst[fwd] = i, j
        edge_src[bwd], edge_dst[bwd] = j, i
        edge_rev[fwd], edge_rev[bwd] = bwd, fwd
        edge_mask[fwd] = edge_mask[bwd] = True
        lp = np.log(p)
        log_psi_e[fwd, :si, :sj] = lp
        log_psi_e[bwd, :sj, :si] = lp.T

    return PGM.from_numpy(dict(
        edge_src=edge_src, edge_dst=edge_dst, edge_rev=edge_rev,
        edge_mask=edge_mask, log_psi_e=log_psi_e, log_psi_v=log_psi_v,
        state_mask=state_mask, n_states=n_states),
        n_vertices, e_dir, dev)
