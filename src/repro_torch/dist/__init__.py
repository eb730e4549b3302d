"""Multi-device BP: split the edge axis over the ranks of a
``torch.distributed`` world, each rank keeping only its slice.

The port of ``repro.dist``. The reference places the edge-axis leaves on
their shards of a JAX mesh and lets XLA partition the engine around a
``shard_map``'d update. PyTorch runs one process per rank instead: every
rank runs the unchanged ``BPEngine`` loop with the same generator seed, on
a **rank-resident** graph and messages.

- **What a rank holds.** Rank ``r`` of ``n`` owns the contiguous, even,
  pair-aligned edge slice ``[lo, hi) = [r*E/n, (r+1)*E/n)`` and keeps, for
  it alone: ``logm`` and the candidate table (E/n, S) f32, ``log_psi_e``
  (E/n, S, S) f32, ``dst_mask`` (E/n, S) int8, ``edge_rev`` (E/n,) int32
  as indices into the slice, and its in-edge table (``SlicePlan``: the
  vertices its edges enter, ~6 bytes per edge of the slice). A bucket keeps
  its flat slice of the (B*E, S) union, which may cross slot boundaries
  (``ShardBatch``).
- **What stays whole**, because the scheduler reads it: ``edge_src``,
  ``edge_dst`` (4 bytes per edge each; a bucket keeps them twice, stacked
  and offset into the union), ``edge_mask`` (1), the residuals gathered
  each round (4), the frontier (1) and the scheduler's state (rlxtree's
  order: 8), plus the O(V*S) vertex arrays (``log_psi_v``, ``state_mask``,
  ``n_states``) and the round's (V, S) vertex sums. So a rank holds about
  ``(4*S*S + 5*S + 10)/n + 10`` bytes per edge (+8 for rlxtree's order,
  +8 for a bucket's union ids) where one device holds about ``4*S*S +
  5*S + 23``: 0.52 of it at n = 2 and S = 16 (``tensor_bytes``).
  Running the scheduler unchanged on the whole residual keeps RBP's
  top-k, RS's ``segment_max``, RnBP's draws from the replicated generator
  and rlx/rlxtree's queues bitwise the one-device selections; every rank
  takes the same decisions and so issues the same collectives in the same
  order.
- **The chain fold** (``vertex_sums``), exact. A vertex's in-edges are
  ascending edge ids and the slices are contiguous in rank order, so they
  split into consecutive runs, one per rank, in rank order. Rank 0 folds
  its runs in ``messages.fold_in_edges``' left-to-right order into a
  (V, S) table and passes it to rank 1 (``comm.send_next``), which folds
  its runs onto it, and so on; a vertex with no earlier in-edge starts from
  its first one, as ``fold_in_edges`` does. The last rank's table is then
  bitwise ``messages.vertex_logprod`` of the whole ``logm``, and it
  ``comm.broadcast``s it. Float data is only passed on or broadcast, never
  ``all_reduce``d. Every sharded run is therefore bitwise the one-device
  run with the same config and generator, at any rank count and for every
  frontier scheduler: rounds, messages, beliefs, updates, history.
- **A round** (``make_sharded_update``): the chain fold; the edge prelude
  on the slice (``logm[edge_rev]`` is local under the co-residency
  contract, ``_check_edge_layout``); the per-edge update on the slice -- on
  CUDA tensors the hand-written kernel ``fused_update_e`` on contiguous
  slices, which launches or raises, on CPU tensors the plain
  ``propagate_ref`` + ``normalize_and_residual`` (the reference's sharded
  body is sum-product); the residual slices gathered in rank order into
  the whole (E,). The engine commits the rank's slice of the frontier.
  Per round a rank exchanges E residuals, n - 1 hops of (V, S) along the
  chain, and one broadcast of (V, S) (none in a world of one).
- **Whole messages** are gathered only at a chunk boundary: for
  ``result`` (``BPResult.logm`` is whole, in rank order, the same on every
  rank), for a slot's result when serving releases it, and when a
  compaction moves slots between ranks (``ShardBatch.narrow``, by
  point-to-point exchanges of just the rows each rank needs).
- **Transport** (``comm``): the mesh's process group as the caller
  initialized it -- NCCL on the card, gloo on the CPU, and gloo through host
  copies when several ranks share one card.
- **Placement.** ``shard_pgm`` (and the engine, at ``init``) turns a whole
  graph or bucket into the rank's rank-resident one; the whole graph may
  sit on the host, so that only the rank's slice ever reaches the card.
  A one-device engine handed a rank-resident graph raises.
- **Sub-meshes.** ``make_bp_mesh(n)`` takes the first ``n`` ranks, and
  ``make_bp_mesh(ranks=...)`` any set of them, as the reference's mesh on a
  device slice: a ``BPMesh``, with the mesh's process group and a gloo
  group on the same ranks for its host decisions. Every rank of the world
  makes every sub-mesh (``new_group`` needs them all; each group is made
  once per world), and a rank outside a mesh holds it with no coordinate:
  an engine built on it there is never run.
- **Serving.** Every rank of a mesh runs the same ``ServingPipeline`` on
  the same stream, and the mesh's rank 0, its leader, takes every decision
  that depends on time or thread timing (admission, eviction, backfill,
  compaction, what the feeder took) and ``comm.publish``es them on the
  gloo group at most twice a cycle; the other ranks apply them
  (``core.serving``). A router's replicas each span a sub-mesh
  (``serve.router``): world rank 0 routes, and each leader pulls its
  requests from it over a ``comm.Channel``.

``make_bp_mesh`` never creates a world: the caller runs
``torch.distributed.init_process_group`` on every rank first (``torchrun``,
or a ``FileStore``; gloo on the CPU, NCCL on GPUs). ``repro_torch.dist.
bp_banded`` adds the halo-exchange path for banded graphs, whose LBP is
bitwise the one-device run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import messages as M
from repro_torch.core.batch import BatchedPGM
from repro_torch.core.engine import BPConfig, BPEngine, BPResult
from repro_torch.core.graph import NEG_INF, PGM, pad_pgm, resolve_device
from repro_torch.dist import comm
from repro_torch.dist.bp_banded import (BANDED_SCHEDULERS, BandedPartition,
                                        partition_banded, run_bp_banded)
from repro_torch.kernels import triton_update as TT

__all__ = [
    "BP_AXIS", "BPMesh", "SlicePlan", "ShardPGM", "ShardBatch",
    "make_bp_mesh",
    "mesh_axis", "require_world", "shard_pgm", "place", "tensor_bytes",
    "slice_update", "make_sharded_update", "make_sharded_engine",
    "run_bp_sharded", "BANDED_SCHEDULERS", "BandedPartition",
    "partition_banded", "run_bp_banded", "comm",
]

#: Default mesh axis name for the sharded edge dimension.
BP_AXIS = "bp"

# a bucket's stacked fields that stay whole on a rank; the rest are empty
_LIGHT = ("edge_src", "edge_dst", "edge_mask", "log_psi_v", "state_mask",
          "n_states")


def require_world() -> None:
    """Raise unless a default ``torch.distributed`` process group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group(...) on every rank first "
            "(gloo on the CPU, nccl on GPUs; torchrun or a FileStore); a bp "
            "mesh spans the initialized world and never creates one")


@dataclasses.dataclass(frozen=True, eq=False)
class BPMesh:
    """A 1-D mesh on ``ranks`` of the world (ascending global ranks), its
    one dimension named ``axis``: the twin of a ``jax.sharding.Mesh`` on a
    device slice. ``group`` is the mesh's process group (the world's own
    when the mesh spans it), ``None`` on a rank outside the mesh, which has
    no coordinate on it. It answers the ``DeviceMesh`` calls the package
    makes (``size``, ``get_local_rank``, ``get_group``,
    ``mesh_dim_names``)."""

    ranks: Tuple[int, ...]
    axis: str
    group: Any = dataclasses.field(repr=False)

    @property
    def mesh_dim_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def member(self) -> bool:
        """Does this process hold a rank of the mesh?"""
        return self.group is not None

    @property
    def host_group(self):
        """A gloo group on the mesh's ranks, for host decisions
        (``comm.publish``): the mesh's own group where that is gloo, else
        one made beside it (by ``make_bp_mesh`` for a sub-mesh, at its
        first use for the whole world's, which every rank reaches
        together); ``None`` off the mesh."""
        return comm.group_of(self.ranks, "gloo") if self.member else None

    def size(self, dim: int | None = None) -> int:
        return len(self.ranks)

    def _check(self, axis) -> None:
        if axis not in (None, self.axis):
            raise ValueError(f"mesh has no axis {axis!r}; its axes: "
                             f"{[self.axis]}")
        if not self.member:
            raise ValueError(
                f"rank {dist.get_rank()} is not on the mesh of ranks "
                f"{list(self.ranks)}; an engine built on it there is never "
                "run")

    def get_local_rank(self, axis: str | None = None) -> int:
        self._check(axis)
        return self.ranks.index(dist.get_rank())

    def get_group(self, axis: str | None = None):
        self._check(axis)
        return self.group


def make_bp_mesh(n_devices: int | None = None, *, axis: str = BP_AXIS,
                 device="cuda", ranks: Sequence[int] | None = None) -> BPMesh:
    """A 1-D ``BPMesh`` named ``axis`` (default ``"bp"``) on the first
    ``n_devices`` ranks of the world (all of them when ``None``), as the
    reference takes the first devices, or on the global ranks ``ranks``;
    ``device`` is where its tensors live (the card by default, which
    raises without one; pass ``device="cpu"`` for a gloo world on the
    CPU).

    The whole world's mesh takes the world's group and makes none. A
    sub-mesh's groups (its own and a gloo one beside it, with the world's
    timeout) are made the first time it is asked for and reused after
    (``comm.group_of``), so every rank of the world makes every sub-mesh,
    members or not, in the same order. With no initialized process group
    it raises a ``RuntimeError`` naming
    ``torch.distributed.init_process_group``."""
    resolve_device(device)
    require_world()
    world = dist.get_world_size()
    if ranks is None:
        ranks = range(n_devices or world)
    ranks = tuple(sorted(int(r) for r in ranks))
    if n_devices is not None and n_devices != len(ranks):
        raise ValueError(f"n_devices={n_devices} but {len(ranks)} ranks "
                         "given")
    if not ranks or len(set(ranks)) != len(ranks) or ranks[0] < 0 or \
            ranks[-1] >= world:
        raise ValueError(f"a bp mesh takes distinct ranks of the world of "
                         f"{world}, got {list(ranks)}")
    group = comm.group_of(ranks)
    if len(ranks) < world:          # made now, while every rank is here
        comm.group_of(ranks, "gloo")
    member = dist.get_rank() in ranks
    return BPMesh(ranks=ranks, axis=axis, group=group if member else None)


def mesh_axis(mesh, axis: str = BP_AXIS):
    """``(n, rank, group)`` of ``mesh`` along ``axis``: its size, this
    process's index on it, and its process group."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes: "
                         f"{list(names)}")
    dim = names.index(axis)
    return (mesh.size(dim), mesh.get_local_rank(axis),
            mesh.get_group(axis))


def _check_edge_layout(pgm: PGM, n_shards: int) -> None:
    """Host-side validation of the sharding contract on a concrete PGM:
    equal even-sized shards, and every reverse edge co-resident with its
    partner (true by construction for every builder of
    ``repro_torch.core.graph`` and for ``BatchedPGM.folded()``)."""
    e = pgm.n_edges
    if e % n_shards:
        raise ValueError(
            f"padded edge count {e} not divisible by {n_shards} shards")
    size = e // n_shards
    if size % 2:
        raise ValueError(
            f"shard size {size} is odd: directed pairs (2k, 2k+1) would "
            "split across shards")
    rev = pgm.edge_rev.cpu().numpy()
    shard_of = np.arange(e) // size
    if not np.all(shard_of == shard_of[rev]):
        raise ValueError(
            "edge_rev crosses a shard boundary; re-pad with "
            "build_pgm/pad_pgm")


# ------------------------------------------------------------ the plan --

@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """Rank ``rank``'s share of a graph on an ``n``-rank mesh: the edge
    slice ``[lo, hi)`` and the rank's part of the chain fold. ``rows``
    (R,) int64 are the vertices the slice's real edges enter, ascending;
    ``in_edges`` (R, D) int32 their in-edges within the slice as indices
    into it (edge - lo), ascending, with ``in_mask`` (R, D) bool and
    ``in_first`` (R, D) bool (the entry is its vertex's first in-edge in
    the whole graph); ``in_pad`` (V,) bool marks the vertices whose
    in-degree is below ``width``, the whole graph's in-edge table width,
    where ``fold_in_edges`` adds 0.0 after the last in-edge."""
    n: int
    rank: int
    lo: int
    hi: int
    width: int
    rows: torch.Tensor
    in_edges: torch.Tensor
    in_mask: torch.Tensor
    in_first: torch.Tensor
    in_pad: torch.Tensor


def _slice_plan(edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                n_vertices: int, width: int, n: int, rank: int) -> SlicePlan:
    """The ``SlicePlan`` of rank ``rank`` from the whole (E,) ``edge_dst``
    and ``edge_mask``, built on their device."""
    dev = edge_dst.device
    size = edge_dst.shape[0] // n
    lo, hi = rank * size, (rank + 1) * size
    real = torch.nonzero(edge_mask).squeeze(1)            # ascending ids
    dst, order = torch.sort(edge_dst[real].long(), stable=True)
    real = real[order]                    # by (destination, edge id)
    counts = torch.bincount(dst, minlength=n_vertices)
    pos = torch.arange(real.numel(), device=dev) - (
        torch.cumsum(counts, 0) - counts)[dst]
    below = torch.bincount(dst[real < lo], minlength=n_vertices)
    keep = (real >= lo) & (real < hi)
    kdst, kpos, kreal = dst[keep], pos[keep], real[keep]
    rows, inv = torch.unique(kdst, return_inverse=True)
    local = kpos - below[kdst]
    d = max(int(local.max()) + 1 if local.numel() else 0, 1)
    table = torch.zeros((rows.numel(), d), dtype=torch.int32, device=dev)
    mask = torch.zeros((rows.numel(), d), dtype=torch.bool, device=dev)
    first = torch.zeros_like(mask)
    table[inv, local] = (kreal - lo).to(torch.int32)
    mask[inv, local] = True
    first[inv, local] = kpos == 0
    return SlicePlan(n=n, rank=rank, lo=lo, hi=hi, width=width,
                     rows=rows, in_edges=table, in_mask=mask, in_first=first,
                     in_pad=counts < width)


# ------------------------------------------------- a rank-resident graph --

@dataclasses.dataclass(frozen=True)
class ShardPGM(PGM):
    """A ``PGM`` as rank ``plan.rank`` of ``plan.n`` holds it (see the
    module docstring): ``edge_src``, ``edge_dst``, ``edge_mask`` and the
    vertex arrays whole; ``log_psi_e``, ``dst_mask`` and ``edge_rev`` (as
    indices into the slice) only for the slice ``[plan.lo, plan.hi)``; the
    in-edge table (``in_edges``/``in_mask``) the plan's. Counts, ``n_edges``
    and ``n_vertices`` are the whole graph's. ``group`` is the mesh axis's
    process group. Only the sharded backend computes on it; messages that
    go with it are the slice's (E/n, S)."""

    plan: SlicePlan = dataclasses.field(kw_only=True, repr=False)
    group: Any = dataclasses.field(kw_only=True, repr=False, compare=False)
    rank_resident: ClassVar[bool] = True

    @property
    def span(self) -> Tuple[int, int]:
        """``(lo, hi)``: the rank's rows of the edge axis."""
        return self.plan.lo, self.plan.hi

    def init_messages(self) -> torch.Tensor:
        """The slice of ``messages.init_messages``."""
        return M.init_messages(self, *self.span)

    def local(self, logm) -> torch.Tensor:
        """The rank's slice of whole messages (E, S), as a new float32
        tensor on the graph's device."""
        if not isinstance(logm, torch.Tensor):
            logm = torch.as_tensor(logm)
        lo, hi = self.span
        part = logm.reshape(-1, logm.shape[-1])[lo:hi]
        return part.to(device=self.device, dtype=torch.float32, copy=True)

    def gather(self, logm: torch.Tensor) -> torch.Tensor:
        """The whole (E, S) messages from every rank's slice, in rank
        order (one gather)."""
        out = logm.new_empty((self.n_edges, logm.shape[1]))
        comm.all_gather_into(out, logm.contiguous(), self.group)
        return out

    def vertex_sums(self, logm: torch.Tensor,
                    rows: Tuple[int, int] | None = None) -> torch.Tensor:
        """The chain fold: ``messages.vertex_logprod`` of the whole
        messages, bitwise, from every rank's slice ``logm``, on every rank
        (rows ``[a, b)`` of it with ``rows=(a, b)``). A collective."""
        plan, group = self.plan, self.group
        a, b = rows if rows is not None else (0, self.n_vertices)
        shape = (b - a, logm.shape[1])
        acc = (logm.new_zeros(shape) if plan.rank == 0
               else comm.recv_prev(logm.new_empty(shape), group))
        take = plan.rows
        ids, mask, first = plan.in_edges, plan.in_mask, plan.in_first
        if rows is not None:
            keep = (take >= a) & (take < b)
            take, ids, mask, first = (take[keep], ids[keep], mask[keep],
                                      first[keep])
        sub = M.fold_in_edges_from(acc[take - a], ids, mask, first, logm)
        acc = acc.index_copy(0, take - a, sub)
        if plan.rank == plan.n - 1:
            acc = torch.where(plan.in_pad[a:b, None], acc + 0.0, acc)
        if plan.n == 1:         # the only rank holds the whole table
            return acc
        comm.send_next(acc, group)
        return comm.broadcast(acc, plan.n - 1, group)

    def beliefs(self, logm: torch.Tensor) -> torch.Tensor:
        """``messages.beliefs`` of the whole messages, bitwise, from the
        slice (a collective: the chain fold)."""
        return M.normalize_beliefs(self.log_psi_v, self.state_mask,
                                   self.vertex_sums(logm))


def _rank_resident(pgm: PGM, n: int, rank: int, group, width: int,
                   device: torch.device) -> ShardPGM:
    """``pgm``'s rank-resident form on ``device``: the whole light fields
    moved there (the same tensors when they are on it), the slice's heavy
    ones copied out, the plan built there."""
    _check_edge_layout(pgm, n)
    size = pgm.n_edges // n
    lo, hi = rank * size, (rank + 1) * size

    def cut(t):
        return t[lo:hi].to(device, copy=True)

    whole = {k: getattr(pgm, k).to(device)
             for k in ("edge_src", "edge_dst", "edge_mask", "log_psi_v",
                       "state_mask", "n_states")}
    plan = _slice_plan(whole["edge_dst"], whole["edge_mask"],
                       pgm.n_vertices, width, n, rank)
    return ShardPGM(
        **whole, edge_rev=pgm.edge_rev[lo:hi].to(device) - lo,
        log_psi_e=cut(pgm.log_psi_e), dst_mask=cut(pgm.dst_mask),
        in_edges=plan.in_edges, in_mask=plan.in_mask,
        n_real_vertices=pgm.n_real_vertices, n_real_edges=pgm.n_real_edges,
        edge_count=pgm.edge_count, vertex_count=pgm.vertex_count,
        plan=plan, group=group)


def shard_pgm(pgm: PGM, mesh, *, axis: str = BP_AXIS,
              device=None) -> ShardPGM:
    """This rank's rank-resident graph (``ShardPGM``) of ``pgm`` over
    ``mesh``, on ``device`` (default: the graph's own). ``pgm`` may sit on
    the host: only the rank's slice of the pairwise tables is copied to
    ``device``. The padded edge count must split into even, pair-aligned
    slices (``run_bp_sharded`` re-pads automatically); a ``ValueError``
    otherwise. A rank-resident graph of the same mesh is returned as it
    is."""
    n, rank, group = mesh_axis(mesh, axis)
    if getattr(pgm, "rank_resident", False):
        _same_mesh(pgm, n, rank)
        return pgm
    dev = pgm.device if device is None else resolve_device(device)
    return _rank_resident(pgm, n, rank, group, pgm.in_edges.shape[-1], dev)


def _same_mesh(graph, n: int, rank: int) -> None:
    union = graph.union if isinstance(graph, ShardBatch) else graph
    if (union.plan.n, union.plan.rank) != (n, rank):
        raise ValueError(
            f"the graph is rank {union.plan.rank} of {union.plan.n}'s "
            f"slice, this mesh's rank is {rank} of {n}")


# ------------------------------------------------ a rank-resident bucket --

def _union_fields(p: PGM) -> dict:
    """The disjoint union's whole light fields from a bucket's stacked
    ones (``BatchedPGM._fold``'s offsets)."""
    b, e = p.edge_src.shape
    v = p.log_psi_v.shape[1]
    rows = torch.arange(b, dtype=torch.int32, device=p.edge_src.device)
    off_v = (rows * v)[:, None]
    return dict(edge_src=(p.edge_src + off_v).reshape(-1),
                edge_dst=(p.edge_dst + off_v).reshape(-1),
                edge_mask=p.edge_mask.reshape(-1),
                log_psi_v=p.log_psi_v.reshape(b * v, -1),
                state_mask=p.state_mask.reshape(b * v, -1),
                n_states=p.n_states.reshape(-1))


def _light(p: PGM, device) -> PGM:
    """A bucket's stacked ``PGM`` keeping only the whole light fields, on
    ``device``; the heavy ones are empty (B, 0, ...) placeholders."""
    b, v = p.edge_src.shape[0], p.log_psi_v.shape[1]
    s = p.log_psi_v.shape[2]
    fields = {k: getattr(p, k).to(device) for k in _LIGHT}
    empty = lambda shape, dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=device)
    return dataclasses.replace(
        p, **fields, edge_rev=empty((b, 0), torch.int32),
        log_psi_e=empty((b, 0, s, s), torch.float32),
        dst_mask=empty((b, 0, s), torch.int8),
        in_edges=empty((b, v, 0), torch.int32),
        in_mask=empty((b, v, 0), torch.bool))


@dataclasses.dataclass(frozen=True)
class ShardBatch(BatchedPGM):
    """A ``BatchedPGM`` bucket as one rank holds it: ``pgm`` keeps the
    stacked whole light fields (the schedulers' and ``graph(i)``'s; the
    pairwise tables, ``dst_mask``, ``edge_rev`` and the in-edge tables are
    empty placeholders), and ``union`` is the rank-resident disjoint union
    (``ShardPGM``), which holds the rank's flat slice of the union's heavy
    leaves. Messages that go with it are the rank's flat (B*E/n, S) slice
    of the union's; a slice may cross slot boundaries.

    ``take`` and ``with_graph`` cannot move messages with the graph and
    raise; ``narrow`` and ``with_slot`` do both."""

    union: ShardPGM = dataclasses.field(kw_only=True, repr=False,
                                        compare=False)
    rank_resident: ClassVar[bool] = True

    @property
    def device(self) -> torch.device:
        return self.union.device

    @property
    def span(self) -> Tuple[int, int]:
        """``(lo, hi)``: the rank's rows of the union's edge axis."""
        return self.union.span

    def folded(self, mesh=None, *, axis: str = "bp") -> ShardPGM:
        """The rank-resident union (``mesh``, if given, must be its
        mesh)."""
        if mesh is not None:
            _same_mesh(self, *mesh_axis(mesh, axis)[:2])
        return self.union

    def init_messages(self) -> torch.Tensor:
        return self.union.init_messages()

    def local(self, logm) -> torch.Tensor:
        return self.union.local(logm)

    def gather(self, logm: torch.Tensor) -> torch.Tensor:
        """The whole (B, E, S) messages, in rank order (one gather)."""
        return self.union.gather(logm).reshape(
            self.size, self.n_edges, logm.shape[1])

    def beliefs(self, logm: torch.Tensor) -> torch.Tensor:
        """(B, V, S) beliefs through the union's chain fold."""
        return self.union.beliefs(logm).reshape(
            self.size, self.n_vertices, -1)

    def slot_messages(self, logm: torch.Tensor, j: int) -> torch.Tensor:
        """Slot ``j``'s whole (E, S) messages: each rank that owns a part
        of its rows broadcasts it, in rank order."""
        lo, hi = self.span
        size, e = hi - lo, self.n_edges
        a, b = j * e, (j + 1) * e
        parts = []
        for r in range(a // size, (b - 1) // size + 1):
            ra, rb = max(a, r * size), min(b, (r + 1) * size)
            buf = (logm[ra - lo:rb - lo].clone() if ra >= lo and rb <= hi
                   else logm.new_empty((rb - ra, logm.shape[1])))
            parts.append(comm.broadcast(buf, r, self.union.group))
        return torch.cat(parts)

    def slot_beliefs(self, logm: torch.Tensor, j: int) -> torch.Tensor:
        """Slot ``j``'s (V, S) beliefs: the chain fold on its vertices."""
        v = self.n_vertices
        u = self.union
        rows = slice(j * v, (j + 1) * v)
        return M.normalize_beliefs(u.log_psi_v[rows], u.state_mask[rows],
                                   u.vertex_sums(logm, (j * v, (j + 1) * v)))

    def take(self, indices):
        raise NotImplementedError(
            "a rank-resident bucket narrows with its messages: "
            "ShardBatch.narrow(logm, indices)")

    def with_graph(self, j, graph):
        raise NotImplementedError(
            "a rank-resident bucket loads a slot with its messages: "
            "ShardBatch.with_slot(logm, j, graph)")

    def _rebuild(self, light: PGM, heavy: dict, width: int) -> "ShardBatch":
        """A bucket with stacked ``light`` fields and the union slice's
        ``heavy`` tensors (``edge_rev`` local, ``log_psi_e``,
        ``dst_mask``); the plan is rebuilt, over the whole union's in-edge
        table ``width``."""
        old = self.union.plan
        whole = _union_fields(light)
        b, e = light.edge_src.shape
        v = light.log_psi_v.shape[1]
        plan = _slice_plan(whole["edge_dst"], whole["edge_mask"], b * v,
                           width, old.n, old.rank)
        union = ShardPGM(
            **whole, **heavy, in_edges=plan.in_edges, in_mask=plan.in_mask,
            n_real_vertices=b * v, n_real_edges=b * e, edge_count=b * e,
            vertex_count=b * v, plan=plan, group=self.union.group)
        return ShardBatch(pgm=light, union=union)

    def with_slot(self, logm: torch.Tensor, j: int, graph: PGM):
        """``(bucket, logm)`` with slot ``j`` holding ``graph`` (padded to
        the bucket's shape; its counts must fit the bucket's ceilings) and
        its rows of the rank's messages reset to the initial ones: what
        ``BatchedPGM.with_graph`` and a fresh slot's ``init_messages`` give
        one device. No collective."""
        row = self.slot_row(graph)
        p = self.pgm
        fields = {}
        for k in _LIGHT:
            full = getattr(p, k).clone()
            full[j] = row[k]
            fields[k] = full
        counts = lambda old, new: old[:j] + (int(new),) + old[j + 1:]  # noqa
        light = dataclasses.replace(
            p, **fields, edge_count=counts(p.edge_count, graph.edge_count),
            vertex_count=counts(p.vertex_count, graph.vertex_count))
        u = self.union
        lo, hi = self.span
        e = self.n_edges
        a, b = max(j * e, lo), min((j + 1) * e, hi)
        heavy = dict(edge_rev=u.edge_rev, log_psi_e=u.log_psi_e,
                     dst_mask=u.dst_mask)
        width = max(u.plan.width, row["in_edges"].shape[-1])
        if a >= b:
            return self._rebuild(light, heavy, width), logm
        src = slice(a - j * e, b - j * e)
        for k, value in (("edge_rev", row["edge_rev"][src] + (j * e - lo)),
                         ("log_psi_e", row["log_psi_e"][src]),
                         ("dst_mask", row["dst_mask"][src])):
            full = heavy[k].clone()
            full[a - lo:b - lo] = value
            heavy[k] = full
        out = self._rebuild(light, heavy, width)
        logm = logm.clone()
        logm[a - lo:b - lo] = M.init_messages(out.union, a, b)
        return out, logm

    def narrow(self, logm: torch.Tensor, indices: Sequence[int]):
        """``(bucket, logm)`` of slots ``indices`` only (the compaction
        primitive, ``BatchedPGM.take`` with the messages): the narrower
        union splits over the ranks anew, and each rank receives the rows
        of its new slice from their old owners (point-to-point). A
        collective."""
        idx = [int(i) for i in indices]
        p = self.pgm
        sel = torch.tensor(idx, dtype=torch.int64, device=self.device)
        light = dataclasses.replace(
            p, **{k: getattr(p, k).index_select(0, sel)
                  for k in _LIGHT + ("edge_rev", "log_psi_e", "dst_mask",
                                     "in_edges", "in_mask")},
            edge_count=tuple(p.edge_count[i] for i in idx),
            vertex_count=tuple(p.vertex_count[i] for i in idx))
        u = self.union
        e, n = self.n_edges, u.plan.n
        total = len(idx) * e
        if total % n or (total // n) % 2:
            raise ValueError(f"{len(idx)} slots of {e} edges do not split "
                             f"into even shards over {n} devices")
        # old union row of every new union row (slots move whole)
        src = (sel[:, None] * e + torch.arange(e, device=self.device)
               ).reshape(-1)
        size = total // n
        new_lo = u.plan.rank * size
        move = lambda t: _move(t, src, u.plan, size, u.group)  # noqa: E731
        # a reverse edge keeps its offset from its edge; local indices
        rev = move(u.edge_rev.to(torch.int64) + u.plan.lo) \
            - src[new_lo:new_lo + size] \
            + torch.arange(size, device=self.device)
        heavy = dict(edge_rev=rev.to(torch.int32),
                     log_psi_e=move(u.log_psi_e), dst_mask=move(u.dst_mask))
        return self._rebuild(light, heavy, u.plan.width), move(logm)


def _move(local: torch.Tensor, src: torch.Tensor, plan: SlicePlan,
          size: int, group) -> torch.Tensor:
    """Rows of a resharded edge axis: new row ``q`` is old row ``src[q]``;
    ``local`` is this rank's old slice (``plan``), the result its new slice
    ``[rank*size, (rank+1)*size)``. Every rank sends each peer the rows it
    owns of the peer's new slice, in the peer's order, and takes its own
    from their owners (one ``comm.exchange``)."""
    old, rank = plan.hi - plan.lo, plan.rank
    out = local.new_empty((size,) + tuple(local.shape[1:]))
    sends, recvs = [], []
    for peer in range(plan.n):
        need = src[peer * size:(peer + 1) * size]
        owner = need // old
        if peer != rank:
            have = need[owner == rank]
            if have.numel():
                sends.append((peer, local[have - plan.lo].contiguous()))
            continue
        for q in range(plan.n):
            at = torch.nonzero(owner == q).squeeze(1)
            if q == rank:
                out[at] = local[need[at] - plan.lo]
            elif at.numel():
                recvs.append((q, local.new_empty((at.numel(),)
                                                 + out.shape[1:]), at))
    comm.exchange(sends, [(q, buf) for q, buf, _ in recvs], group)
    for _, buf, at in recvs:
        out[at] = buf
    return out


def place(graph, mesh, *, axis: str = BP_AXIS, device=None):
    """This rank's rank-resident form of a whole ``PGM`` (``shard_pgm``)
    or ``BatchedPGM`` bucket (a ``ShardBatch``) over ``mesh``, on ``device``
    (default: the graph's own); the whole graph may sit on the host. A
    rank-resident graph of the same mesh is returned as it is; anything
    else passes through untouched (the engine's checks refuse it)."""
    n, rank, group = mesh_axis(mesh, axis)
    if getattr(graph, "rank_resident", False):
        _same_mesh(graph, n, rank)
        return graph
    if isinstance(graph, BatchedPGM):
        dev = graph.device if device is None else resolve_device(device)
        whole = graph.folded()
        union = _rank_resident(whole, n, rank, group,
                               whole.in_edges.shape[-1], dev)
        return ShardBatch(pgm=_light(graph.pgm, dev), union=union)
    if isinstance(graph, PGM):
        return shard_pgm(graph, mesh, axis=axis, device=device)
    return graph


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors reachable from ``objs`` through dataclass
    fields, sequences and dicts, each storage counted once: what a
    graph, a ``BPState`` or messages hold on their device."""
    seen, total, stack = set(), 0, list(objs)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            key = (st.data_ptr(), x.device)
            if key not in seen:
                seen.add(key)
                total += st.nbytes()
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


# ------------------------------------------------------------- a round --

def slice_update(log_psi_e: torch.Tensor, pre: torch.Tensor,
                 logm: torch.Tensor, dst_mask: torch.Tensor,
                 edge_mask: torch.Tensor):
    """The sum-product update of a contiguous run of edges:
    ``(cand, resid)``. CUDA tensors go through the hand-written kernel
    ``fused_update_e`` (which launches or raises), CPU tensors through the
    plain ``propagate_ref`` + ``normalize_and_residual``. Fake tensors (the
    dry run, ``launch.dryrun``) stand for the card's: they take the
    kernel's op, which gives shapes."""
    if logm.is_cuda or is_fake(logm):
        return TT.fused_update_e(log_psi_e, pre, logm, dst_mask,
                                 semiring="sum")
    cand = M.propagate_ref(log_psi_e, pre)
    return M.normalize_and_residual(cand, logm, dst_mask != 0, edge_mask)


def _mesh_device(backend: str) -> str:
    return "cuda" if backend == "nccl" else "cpu"


def make_sharded_update(mesh=None, *, axis: str = BP_AXIS):
    """Build the multi-device message-update backend.

    Returns an ``update_fn(pgm, logm) -> (cand (E/n, S) f32, resid (E,)
    f32)`` on a rank-resident graph (``ShardPGM``) and the rank's slice of
    the messages: the rank's slice of ``messages.ref_update``'s candidates,
    bitwise, and the whole residual vector, gathered in rank order. A
    collective. ``update_fn.mesh`` and ``.axis`` are the seam the engine's
    bucket fold reads, and ``update_fn.place(graph, device)`` (``place``)
    the one its ``init`` calls. With ``mesh=None`` a mesh over the whole
    initialized world is built now -- what the registry entry
    ``UPDATE_BACKENDS["sharded"]`` does, so ``BPConfig(backend="sharded")``
    stays a plain string; that mesh is named after the world's backend
    (``"cuda"`` for NCCL, else ``"cpu"``), which moves no tensor. On a rank
    outside a sub-mesh the backend builds, and raises if it is called.

    Contract on the graph: the padded edge count splits into even-sized
    slices (``E % n == 0`` and ``E/n`` even) with reverse pairs on one rank.
    ``run_bp_sharded`` re-pads a single graph; a bucket's folded ``B*E``
    (a multiple of ``EDGE_PAD = 128``) splits over any power-of-two mesh of
    at most 64 ranks."""
    if mesh is None:
        require_world()
        mesh = make_bp_mesh(axis=axis,
                            device=_mesh_device(dist.get_backend()))
    if getattr(mesh, "member", True):
        n, rank, group = mesh_axis(mesh, axis)
    else:       # built on every rank, run only on the mesh's own
        n, rank, group = mesh.size(), None, None

    def update_fn(pgm: PGM, logm: torch.Tensor):
        if group is None:
            mesh_axis(mesh, axis)       # raises: not on the mesh
        if not getattr(pgm, "rank_resident", False):
            e = logm.shape[0]
            if e % n or (e // n) % 2:
                raise ValueError(
                    f"edge axis {e} does not split into even shards over "
                    f"{n} devices; pad with pad_pgm (run_bp_sharded does "
                    "this)")
            raise ValueError("the sharded update runs on a rank-resident "
                             "graph (shard_pgm) and the rank's slice of the "
                             "messages")
        _same_mesh(pgm, n, rank)
        lo, hi = pgm.span
        if logm.shape[0] != hi - lo:
            raise ValueError(f"rank {rank} holds edges [{lo}, {hi}), got "
                             f"{logm.shape[0]} rows of messages")
        vsum = pgm.vertex_sums(logm)
        src = pgm.edge_src[lo:hi]
        pre = pgm.log_psi_v[src] + vsum[src] - logm[pgm.edge_rev]
        pre = torch.where(pgm.state_mask[src], pre, NEG_INF)
        cand, resid_s = slice_update(pgm.log_psi_e, pre, logm,
                                     pgm.dst_mask, pgm.edge_mask[lo:hi])
        resid = logm.new_empty((pgm.n_edges,))
        comm.all_gather_into(resid, resid_s, group)
        return cand, resid

    update_fn.mesh = mesh             # the engine's bucket fold reads these
    update_fn.axis = axis
    update_fn.place = lambda graph, device=None: place(
        graph, mesh, axis=axis, device=device)
    return update_fn


def make_sharded_engine(scheduler, mesh=None, *, axis: str = BP_AXIS,
                        device="cuda", **config) -> BPEngine:
    """A ``BPEngine`` on ``device`` whose message update runs sharded over
    ``mesh``. ``scheduler`` is a ``Scheduler`` instance or registry spec
    string; ``config`` holds the remaining ``BPConfig`` fields (eps,
    max_rounds, damping, chunk_rounds, history, ...). Its ``init`` makes the
    graph rank-resident; scheduler selection, the convergence vote and the
    frontier run replicated on every rank, and each rank commits its slice,
    so ``init``/``step`` resume and ``serve`` evacuation work unchanged."""
    dev = resolve_device(device)
    return BPEngine(BPConfig(scheduler=scheduler,
                             backend=make_sharded_update(mesh, axis=axis),
                             **config), device=dev)


def run_bp_sharded(pgm: PGM, scheduler, mesh, rng: torch.Generator, *,
                   eps: float = 1e-3, max_rounds: int = 2000,
                   damping: float = 0.0, chunk_rounds: int | None = None,
                   history: bool = True, axis: str = BP_AXIS,
                   device="cuda") -> BPResult:
    """One-shot sharded BP: beliefs for ``pgm`` computed over ``mesh``.

    Call it on every rank with the same graph (on the host or on
    ``device``) and a generator on ``device`` seeded alike. Returns the
    engine's ``BPResult``, the same on every rank: ``beliefs (V, S)``,
    ``logm (E', S)`` with ``E'`` the edge count re-padded to a multiple of
    ``2 * n`` (real edges keep their places), ``rounds``, ``converged``,
    bitwise a one-device run of the re-padded graph with the same config
    and generator."""
    dev = resolve_device(device)
    n, _, _ = mesh_axis(mesh, axis)
    if not getattr(pgm, "rank_resident", False):
        e = pgm.n_edges
        need = -(-e // (2 * n)) * (2 * n)
        if need != e:
            pgm = pad_pgm(pgm, n_edges=need, n_vertices=pgm.n_vertices,
                          n_states=pgm.n_states_max)
    engine = make_sharded_engine(scheduler, mesh, axis=axis, device=dev,
                                 eps=eps, max_rounds=max_rounds,
                                 damping=damping, chunk_rounds=chunk_rounds,
                                 history=history)
    return engine.run(shard_pgm(pgm, mesh, axis=axis, device=dev), rng)
