"""Banded BP: contiguous edge bands + neighbour-only halo exchange.

The port of ``repro.dist.bp_banded``. ``repro_torch.dist`` (the general
sharded path) passes a (V, S) vertex table along every rank each round.
For *banded* graphs -- chains, grids, any MRF whose adjacency matrix has
small bandwidth under its natural vertex order -- a contiguous vertex block
only ever needs messages from the blocks directly beside it:

- ``partition_banded(pgm, n)`` (host numpy, bitwise the reference's arrays)
  reorders the real directed edges into global *stable destination order*
  and cuts them into ``n`` contiguous bands at vertex-block boundaries
  (blocks balanced by in-degree). The banded contract -- **every edge
  connects vertices in the same or adjacent blocks** -- is asserted;
  irregular graphs (random geometric / protein-like contact maps) are
  rejected with ``AssertionError``.
- ``run_bp_banded(part, sched, mesh, rng)`` runs the frontier loop in every
  rank's process, each holding its own band's (L, S) messages. Per round a
  rank sends its band to its two neighbours and receives theirs
  (``batch_isend_irecv``, through ``comm.exchange``), folds the incoming
  messages of exactly the vertices its band reads, runs the per-band update
  -- ``fused_update_e`` on the card, the plain version on the CPU
  (``dist.slice_update``) -- and commits its own band's frontier. The only
  global collective is the integer count of unconverged edges, shared by
  the convergence vote and RnBP's controller. At the end the bands are
  gathered back into the original edge layout on every rank.

Round-exactness: a vertex's incoming edges all live in one band, and the
stable sort keeps their original relative order, so each vertex folds its
in-edges in ascending edge order -- the order of ``messages.
vertex_logprod`` -- and every per-edge step is the one-device run's on the
same values. Banded LBP therefore reproduces the one-device trajectory
bitwise, rounds and messages. Stochastic schedulers draw per rank from
``slot_generator(base, rank)`` (the reference's ``fold_in(rng, shard)``);
they converge to the same quality but not along the same trajectory.

Priority scheduling: *exact* sort-based schedulers (RBP/RS) need a global
top-k per round, which defeats neighbour-only communication -- they raise
the registry-style unsupported error below; use ``run_bp_sharded`` for
them. The *relaxed* family (RLX/RLXTree) runs natively: band slots are in
stable destination order, so contiguous band-local queues are at once
storage-contiguous (rlx's partition) and destination-ordered (rlxtree's),
and per-queue top-k selection stays rank-local, each rank always keeping
its own max-residual queue. ``BANDED_SCHEDULERS`` names the supported
subset.

The reference caches its compiled ``shard_map`` loop per partition; the
port's loop is Python over tensors, compiles nothing, and keeps no cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import messages as M
from repro_torch.core.batch import slot_generator
from repro_torch.core.engine import SYNC_ROUNDS
from repro_torch.core.graph import NEG_INF, PGM, _in_edge_table
from repro_torch.core.registry import Registry
from repro_torch.core.schedulers import LBP, RLX, RLXTree, RnBP, get_scheduler
from repro_torch.core.schedulers.rlx import queue_count, relaxed_frontier

__all__ = ["BANDED_SCHEDULERS", "BandedPartition", "partition_banded",
           "run_bp_banded"]

#: The scheduler subset the banded runner supports (exact sort-based
#: priorities need a global top-k and are excluded). Same Registry class as
#: ``SCHEDULERS``, so the unsupported-scheduler error carries the uniform
#: "unknown X ...; registered: [...]" format.
BANDED_SCHEDULERS = Registry("banded scheduler", {
    "lbp": LBP,
    "rlx": RLX,
    "rlxtree": RLXTree,
    "rnbp": RnBP,
})


@dataclasses.dataclass(frozen=True)
class BandedPartition:
    """``n`` contiguous edge bands of a banded PGM, padded to equal length,
    as host numpy arrays.

    Slot layout: band ``s`` occupies flattened slot coordinates
    ``[s*band_len, (s+1)*band_len)``; real slots are the band's edges in
    global stable-dst order, trailing slots are inert (mask False, pointing
    at the dummy vertex). Per-slot arrays are ``(n, band_len)``
    (``log_psi_e``: ``(n, band_len, S, S)`` f32); ``edge_rev`` holds
    *flattened slot* coordinates of the reverse edge (always in the same or
    an adjacent band). ``slot_edge`` maps slots back to original edge ids
    (-1 for inert slots); ``v_lo`` gives the vertex blocks
    ``[v_lo[s], v_lo[s+1])``.
    """

    pgm: PGM                    # original graph (vertex tables, beliefs)
    n: int                      # number of bands == mesh size to run on
    band_len: int               # padded slots per band
    v_lo: np.ndarray            # (n+1,) int64 vertex block boundaries
    edge_src: np.ndarray        # (n, L) int32
    edge_dst: np.ndarray        # (n, L) int32
    edge_rev: np.ndarray        # (n, L) int32, flattened slot coords
    edge_mask: np.ndarray       # (n, L) bool
    log_psi_e: np.ndarray       # (n, L, S, S) f32
    slot_edge: np.ndarray       # (n, L) int64, original edge id or -1


def partition_banded(pgm: PGM, n: int) -> BandedPartition:
    """Cut ``pgm`` into ``n`` contiguous edge bands for halo-exchange BP.

    Vertices are split into ``n`` contiguous blocks balanced by in-degree;
    each band is the (stable dst-sorted) slice of directed edges pointing
    into one block. Asserts the **banded contract**: every real edge must
    connect vertices in the same or adjacent blocks, so one band of halo on
    each side covers all remote reads. Chains and row-major grids pass for
    any reasonable ``n``; irregular spatial graphs (e.g.
    ``protein_like_graph``) fail it and must use ``run_bp_sharded``.
    """
    # Contract violations raise AssertionError explicitly (not via the
    # `assert` statement): rejection is API behavior, kept under `python -O`.
    if n < 1:
        raise AssertionError(f"need n >= 1 bands, got {n}")
    host = pgm.to_numpy()
    src, dst, rev, mask = (host[k] for k in ("edge_src", "edge_dst",
                                             "edge_rev", "edge_mask"))
    nv = pgm.n_real_vertices
    real = np.flatnonzero(mask)
    if real.size == 0:
        raise AssertionError("empty graph")
    # Global stable destination order: every vertex's incoming edges stay in
    # their original relative order (the round-exactness invariant).
    order = real[np.argsort(dst[real], kind="stable")]
    e_real = order.size

    # Vertex blocks [v_lo[s], v_lo[s+1]) balanced by in-degree.
    indeg = np.bincount(dst[order], minlength=nv)
    cum0 = np.concatenate([[0], np.cumsum(indeg)])          # (nv+1,)
    targets = np.arange(1, n) * (e_real / n)
    cuts = np.searchsorted(cum0[1:], targets, side="left") + 1
    v_lo = np.concatenate([[0], np.clip(cuts, 0, nv), [nv]])
    v_lo = np.maximum.accumulate(v_lo)
    block = np.searchsorted(v_lo, np.arange(nv), side="right") - 1  # (nv,)

    # The banded contract: edges never skip over a block.
    span = np.abs(block[src[order]] - block[dst[order]])
    if int(span.max(initial=0)) > 1:
        raise AssertionError(
            f"graph is not banded for n={n}: an edge spans "
            f"{int(span.max())} vertex blocks (> 1); re-order vertices or "
            "use run_bp_sharded")

    # Band s = sorted positions [p_lo[s], p_lo[s+1]).
    p_lo = cum0[v_lo]                                       # (n+1,)
    band_len = max(int(np.max(p_lo[1:] - p_lo[:-1])), 1)

    # Slot of each sorted position: band s, offset p - p_lo[s].
    pos_band = np.searchsorted(p_lo, np.arange(e_real), side="right") - 1
    pos_slot = pos_band * band_len + (np.arange(e_real) - p_lo[pos_band])
    slot_of = np.full(pgm.n_edges, -1, dtype=np.int64)
    slot_of[order] = pos_slot

    dummy = nv
    total = n * band_len
    b_src = np.full(total, dummy, dtype=np.int32)
    b_dst = np.full(total, dummy, dtype=np.int32)
    b_rev = np.arange(total, dtype=np.int32)                # inert: self
    b_mask = np.zeros(total, dtype=bool)
    s_pad = pgm.n_states_max
    b_psi = np.zeros((total, s_pad, s_pad), dtype=np.float32)
    slot_edge = np.full(total, -1, dtype=np.int64)

    b_src[pos_slot] = src[order]
    b_dst[pos_slot] = dst[order]
    b_rev[pos_slot] = slot_of[rev[order]]
    b_mask[pos_slot] = True
    b_psi[pos_slot] = host["log_psi_e"][order]
    slot_edge[pos_slot] = order

    # Reverse edges stay within one band of halo (implied by the contract;
    # kept as a hard invariant because the runner indexes the halo window).
    rev_band = b_rev[pos_slot] // band_len
    if int(np.abs(rev_band - pos_band).max(initial=0)) > 1:
        raise AssertionError("reverse edge escaped the one-band halo")

    shape = (n, band_len)
    return BandedPartition(
        pgm=pgm, n=n, band_len=band_len, v_lo=v_lo,
        edge_src=b_src.reshape(shape), edge_dst=b_dst.reshape(shape),
        edge_rev=b_rev.reshape(shape), edge_mask=b_mask.reshape(shape),
        log_psi_e=b_psi.reshape(shape + (s_pad, s_pad)),
        slot_edge=slot_edge.reshape(shape))


@dataclasses.dataclass(frozen=True)
class _Band:
    """One rank's band on the device. The *window* is the concatenation of
    the bands ``[s-1 | s | s+1]`` that exist (one band at the ends);
    ``rev`` and ``in_edges`` index it."""
    lo: int                     # first band of the window
    hi: int                     # last band of the window
    src: torch.Tensor           # (L,) source vertex per slot
    rev: torch.Tensor           # (L,) reverse slot, window coordinates
    mask: torch.Tensor          # (L,) bool real slot
    dst_mask: torch.Tensor      # (L, S) int8 state_mask[dst]
    log_psi_e: torch.Tensor     # (L, S, S)
    row: torch.Tensor           # (L,) row of the slot's source in in_edges
    in_edges: torch.Tensor      # (R, D) window slots into each read vertex
    in_mask: torch.Tensor       # (R, D) bool


def _band(part: BandedPartition, s: int) -> _Band:
    """Rank ``s``'s band: its slots, and the in-edge table of every vertex
    its slots read (their sources), over its window, in window order --
    which is global stable-dst order, so each vertex lists its in-edges in
    ascending original edge id."""
    n, length = part.n, part.band_len
    lo, hi = max(s - 1, 0), min(s + 1, n - 1)
    src = part.edge_src[s]
    need = np.unique(src)                      # sorted; the dummy included
    w_dst = part.edge_dst[lo:hi + 1].reshape(-1)
    w_mask = part.edge_mask[lo:hi + 1].reshape(-1)
    rows = np.minimum(np.searchsorted(need, w_dst), need.size - 1)
    sel = w_mask & (need[rows] == w_dst)
    table, tmask = _in_edge_table(rows, sel, need.size)
    pgm = part.pgm
    dev = pgm.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    src_t = t(src)
    return _Band(
        lo=lo, hi=hi, src=src_t,
        rev=t(part.edge_rev[s].astype(np.int64) - lo * length),
        mask=t(part.edge_mask[s]),
        dst_mask=pgm.state_mask[t(part.edge_dst[s])].to(torch.int8),
        log_psi_e=t(part.log_psi_e[s]),
        row=t(np.searchsorted(need, src)), in_edges=t(table),
        in_mask=t(tmask))


def _halo(logm: torch.Tensor, band: _Band, s: int, group) -> torch.Tensor:
    """The window ``[left | own | right]`` of messages: this rank's band
    goes to each neighbour, and theirs come back."""
    from repro_torch.dist import comm
    sends, recvs, parts = [], [], []
    for peer in (s - 1, s + 1):
        if band.lo <= peer <= band.hi:
            buf = torch.empty_like(logm)
            sends.append((peer, logm))
            recvs.append((peer, buf))
    comm.exchange(sends, recvs, group)
    got = dict((peer, buf) for peer, buf in recvs)
    for b in range(band.lo, band.hi + 1):
        parts.append(logm if b == s else got[b])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def run_bp_banded(part: BandedPartition, scheduler, mesh, rng, *,
                  eps: float = 1e-3, max_rounds: int = 2000,
                  damping: float = 0.0):
    """Frontier BP over ``mesh`` with one band per rank and neighbour-only
    halo exchange; returns ``(logm, rounds, done)`` on every rank.

    ``logm`` is ``(E, S) f32`` final messages in the *original* pgm edge
    layout (padded edges keep their initial values, as in the one-device
    loop); ``rounds`` is the 0-d int32 count of committed sweeps and
    ``done`` the 0-d bool convergence flag -- True iff every real edge's
    residual fell below ``eps`` within ``max_rounds``. Tensors live on the
    graph's device. ``scheduler`` may be ``LBP()`` (bitwise the one-device
    run, see the module docstring), ``RnBP(...)`` / ``RLX(...)`` /
    ``RLXTree(...)`` (per-rank generators ``slot_generator(base, rank)``,
    ``rng`` being the base seed: an int or a ``torch.Generator``, whose
    ``initial_seed()`` is taken), or a registry spec string for any of them;
    exact sort-based schedulers raise ``NotImplementedError`` carrying the
    uniform registry message that names the supported subset
    (``BANDED_SCHEDULERS``). Run it on every rank of the mesh.
    """
    from repro_torch.dist import comm, mesh_axis, slice_update
    if isinstance(scheduler, str):
        scheduler = get_scheduler(scheduler)
    if not isinstance(scheduler, tuple(BANDED_SCHEDULERS.values())):
        raise NotImplementedError(
            f"{type(scheduler).__name__} needs a global sort per round "
            "(use run_bp_sharded); "
            + BANDED_SCHEDULERS.unknown(type(scheduler).__name__.lower()))
    if scheduler.inner_sweeps != 1:
        raise NotImplementedError(
            f"inner_sweeps={scheduler.inner_sweeps}: the banded loop runs "
            "one sweep per round; !=1 would break round parity with the "
            "engine")
    n, length = part.n, part.band_len
    axis = mesh.mesh_dim_names[0]
    size, s, group = mesh_axis(mesh, axis)
    if size != n:
        raise AssertionError(
            f"partition has {n} bands but mesh axis {axis!r} has "
            f"{size} devices")
    pgm = part.pgm
    dev = pgm.device
    band = _band(part, s)
    e_real = int(part.edge_mask.sum())
    base = rng.initial_seed() if isinstance(rng, torch.Generator) \
        else int(rng)
    gen = slot_generator(base, s, dev)

    rnbp = isinstance(scheduler, RnBP)
    relaxed = isinstance(scheduler, (RLX, RLXTree))
    if relaxed:
        # `queues` is the global relaxation degree: each of the n ranks
        # hosts its share, and the per-queue k divides the global frontier
        # budget p*|E| over all queues. Selection is entirely rank-local.
        q_band = queue_count(length, max(1, scheduler.queues // n))
        k_band = min(max(1, int(round(
            scheduler.p * e_real / (q_band * n)))), length // q_band)

    # Initial messages: the one-device run's, slot by slot.
    slots = torch.from_numpy(part.slot_edge[s]).to(dev)
    init = M.init_messages(pgm)
    logm = init[slots.clamp(min=0)]
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    old_count = torch.tensor(float(e_real), dtype=torch.float32, device=dev)
    for it in range(max_rounds):
        active = ~done
        window = _halo(logm, band, s, group)
        # Incoming sums of every vertex the band reads: all its in-edges
        # lie in the window (banded contract), in global stable order.
        vsum = M.fold_in_edges(band.in_edges, band.in_mask, window)
        pre = pgm.log_psi_v[band.src] + vsum[band.row] - window[band.rev]
        pre = torch.where(pgm.state_mask[band.src], pre, NEG_INF)
        cand, resid = slice_update(band.log_psi_e, pre, logm, band.dst_mask,
                                   band.mask)
        unconverged = comm.all_reduce_count(
            ((resid >= eps) & band.mask).sum(), group)
        if rnbp:
            new_count = unconverged.to(torch.float32)
            ratio = new_count / torch.clamp(old_count, min=1.0)
            p = torch.where(ratio > scheduler.ratio_threshold,
                            scheduler.low_p, scheduler.high_p)
            keep = torch.rand((length,), generator=gen, dtype=torch.float32,
                              device=dev) < p
            frontier = (resid >= eps) & band.mask & keep
            old_count = torch.where(active, new_count, old_count)
        elif relaxed:
            # Per-queue top-k of a sampled queue subset, rank-local; each
            # rank always keeps its own max-residual queue, so the rank
            # holding the global max commits it -- no livelock, no global
            # sort.
            res2 = torch.where(band.mask, resid, 0.0).reshape(
                q_band, length // q_band)
            draw = torch.rand((q_band,), generator=gen, dtype=torch.float32,
                              device=dev)
            frontier = relaxed_frontier(res2, k_band, scheduler.sample,
                                        draw).reshape(length)
        else:
            frontier = band.mask
        newly_done = (unconverged == 0) & active
        frontier = frontier & active & ~newly_done
        logm = M.apply_frontier(logm, cand, frontier, damping)
        rounds = rounds + (active & ~newly_done).to(torch.int32)
        done = done | newly_done
        if (it + 1) % SYNC_ROUNDS == 0 and bool(done):
            break
    # Gather the bands back into the original edge layout; untouched padded
    # edges keep their initial values, as in the one-device loop.
    flat = logm.new_empty((n * length, logm.shape[1]))
    comm.all_gather_into(flat, logm, group)
    live = np.flatnonzero(part.slot_edge.reshape(-1) >= 0)
    out = init.clone()
    out[torch.from_numpy(part.slot_edge.reshape(-1)[live]).to(dev)] = \
        flat[torch.from_numpy(live).to(dev)]
    return out, rounds, done
