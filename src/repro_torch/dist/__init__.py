"""Multi-device BP: split the edge axis over the ranks of a
``torch.distributed`` world.

The port of ``repro.dist``. The reference shards the directed-edge axis of
``logm`` over a JAX mesh and lets XLA partition the engine around a
``shard_map``'d update. PyTorch runs one process per rank instead, so the
port splits the work, not the state:

- **Every rank runs the unchanged ``BPEngine``** on whole-shape state
  (``logm`` (E, S) and the residuals are replicated), with the same
  generator seed. The scheduler's draws, the convergence vote, the host's
  reads of ``done``, chunked ``step`` resume and the serving decisions are
  then the same on every rank, so every rank issues the same collectives in
  the same order, and every rank's ``logm`` is bitwise equal.
- **The ``"sharded"`` update** (``make_sharded_update``) is an ordinary
  ``(pgm, logm) -> (cand (E, S), resid (E,))`` backend. Rank ``r`` owns the
  contiguous, even-sized slice ``[r*E/n, (r+1)*E/n)`` of the edge axis:
  1. it folds the incoming messages of its slice's edges into a (V, S)
     partial table, through an in-edge table restricted to the slice
     (``SlicePlan``, built once per graph on the host and kept with it),
     left to right as ``messages.vertex_logprod`` does -- no float atomics;
  2. it gathers every rank's partial table and adds them in rank order,
     ``p0 + p1 + ...`` -- never a float ``all_reduce``, whose order the
     library picks. With one rank this is exactly ``vertex_logprod``;
  3. it runs the edge prelude on its slice: ``logm`` is replicated, so the
     reverse lookup ``logm[edge_rev]`` is local, and the reference's
     co-residency contract is still enforced with its ``ValueError``s
     (``_check_edge_layout``);
  4. it runs the per-edge update on its slice: on CUDA tensors the
     hand-written kernel ``fused_update_e`` on contiguous views, on CPU
     tensors the plain ``propagate_ref`` + ``normalize_and_residual`` (the
     reference's sharded body is sum-product). The tensors' device decides,
     and nothing else: a kernel that fails to build or launch fails the call;
  5. it gathers the candidate and residual slices, in rank order, into the
     replicated (E, S) and (E,) outputs.
- **Transport** (``comm``): the mesh's process group as the caller
  initialized it -- NCCL on the card, gloo on the CPU, and gloo through host
  copies when several ranks share one card.
- **Memory.** Every rank holds the whole ``logm`` and the whole graph; only
  the per-edge work is 1/n. The reference keeps ``logm`` sharded.
- **Serving.** A serving decision taken from the wall clock can differ
  between ranks, and a rank that diverges deadlocks the next collective. So
  ``ServingPipeline`` refuses the sharded backend with ``windowed`` or
  ``deadline`` admission on a wall clock (a ``SweepClock`` is fine) and with
  ingest threads, and the router tier refuses it outright, each with a
  ``NotImplementedError``.

``make_bp_mesh`` never creates a world: the caller runs
``torch.distributed.init_process_group`` on every rank first (``torchrun``,
or a ``FileStore``; gloo on the CPU, NCCL on GPUs). ``repro_torch.dist.
bp_banded`` adds the halo-exchange path for banded graphs, whose LBP is
bitwise the one-device run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import messages as M
from repro_torch.core.engine import BPConfig, BPEngine, BPResult
from repro_torch.core.graph import (NEG_INF, PGM, _in_edge_table, pad_pgm,
                                    resolve_device)
from repro_torch.dist import comm
from repro_torch.dist.bp_banded import (BANDED_SCHEDULERS, BandedPartition,
                                        partition_banded, run_bp_banded)
from repro_torch.kernels import triton_update as TT

__all__ = [
    "BP_AXIS", "SlicePlan", "make_bp_mesh", "mesh_axis", "require_world",
    "shard_pgm", "rank_order_sum", "slice_update", "make_sharded_update",
    "make_sharded_engine", "run_bp_sharded", "BANDED_SCHEDULERS",
    "BandedPartition", "partition_banded", "run_bp_banded", "comm",
]

#: Default mesh axis name for the sharded edge dimension.
BP_AXIS = "bp"


def require_world() -> None:
    """Raise unless a default ``torch.distributed`` process group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group(...) on every rank first "
            "(gloo on the CPU, nccl on GPUs; torchrun or a FileStore); a bp "
            "mesh spans the initialized world and never creates one")


def make_bp_mesh(n_devices: int | None = None, *, axis: str = BP_AXIS,
                 device="cuda"):
    """1-D ``DeviceMesh`` over the default group's ranks, its one dimension
    named ``axis`` (default ``"bp"``), built by ``init_device_mesh`` on
    ``device``'s type (the card by default; pass ``device="cpu"`` for a
    gloo world on the CPU).

    The mesh spans the whole world: ``n_devices`` is ``None`` or the world
    size. With no initialized process group it raises a ``RuntimeError``
    naming ``torch.distributed.init_process_group``."""
    dev = resolve_device(device)
    require_world()
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a bp mesh spans the whole world of {world} "
                         f"ranks, asked for {n}; start a world of {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


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


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """Rank ``rank``'s share of a graph on an ``n``-rank mesh: the edge
    slice ``[lo, hi)`` and the incoming-edge table restricted to it --
    ``in_edges`` (V, D) int32 global edge ids of the slice's real edges
    into each vertex, ascending, with ``in_mask`` (V, D) bool (D the widest
    such in-degree, >= 1)."""
    n: int
    rank: int
    lo: int
    hi: int
    in_edges: torch.Tensor
    in_mask: torch.Tensor


def _build_plan(pgm: PGM, n: int, rank: int) -> SlicePlan:
    _check_edge_layout(pgm, n)
    size = pgm.n_edges // n
    lo, hi = rank * size, (rank + 1) * size
    table, mask = _in_edge_table(pgm.edge_dst[lo:hi].cpu().numpy(),
                                 pgm.edge_mask[lo:hi].cpu().numpy(),
                                 pgm.n_vertices)
    dev = pgm.device
    return SlicePlan(n=n, rank=rank, lo=lo, hi=hi,
                     in_edges=torch.from_numpy(table + np.int32(lo)).to(dev),
                     in_mask=torch.from_numpy(mask).to(dev))


def _plan(pgm: PGM, n: int, rank: int) -> SlicePlan:
    return pgm.memo(("bp_slice", n, rank), lambda: _build_plan(pgm, n, rank))


def shard_pgm(pgm: PGM, mesh, *, axis: str = BP_AXIS) -> PGM:
    """Check ``pgm``'s layout against ``mesh`` and keep this rank's
    ``SlicePlan`` with it; returns ``pgm`` itself. Every rank keeps the
    whole graph (the reference places edge-axis arrays on their shards;
    here only the plan is per rank). The padded edge count must split into
    even, pair-aligned slices (``run_bp_sharded`` re-pads automatically)."""
    n, rank, _ = mesh_axis(mesh, axis)
    _plan(pgm, n, rank)
    return pgm


def slice_update(log_psi_e: torch.Tensor, pre: torch.Tensor,
                 logm: torch.Tensor, dst_mask: torch.Tensor,
                 edge_mask: torch.Tensor):
    """The sum-product update of a contiguous run of edges:
    ``(cand, resid)``. CUDA tensors go through the hand-written kernel
    ``fused_update_e`` (which launches or raises), CPU tensors through the
    plain ``propagate_ref`` + ``normalize_and_residual``."""
    if logm.is_cuda:
        return TT.fused_update_e(log_psi_e, pre, logm, dst_mask,
                                 semiring="sum")
    cand = M.propagate_ref(log_psi_e, pre)
    return M.normalize_and_residual(cand, logm, dst_mask != 0, edge_mask)


def rank_order_sum(parts):
    """``((p0 + p1) + p2) + ...``: gathered partial tables added in rank
    order, the same on every rank and in every run (a float ``all_reduce``
    would add in an order the library picks)."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _mesh_device(backend: str) -> str:
    return "cuda" if backend == "nccl" else "cpu"


def make_sharded_update(mesh=None, *, axis: str = BP_AXIS):
    """Build the multi-device message-update backend.

    Returns an ``update_fn(pgm, logm) -> (cand (E, S) f32, resid (E,) f32)``
    with the signature and semantics of ``messages.ref_update``, equal up to
    float reassociation in the per-vertex sum where a vertex's in-edges span
    ranks (see the module docstring). ``update_fn.mesh`` and ``.axis`` are
    the seam the engine's bucket fold reads. With ``mesh=None`` a mesh over
    the whole initialized world is built now -- what the registry entry
    ``UPDATE_BACKENDS["sharded"]`` does, so ``BPConfig(backend="sharded")``
    stays a plain string; that mesh is named after the world's backend
    (``"cuda"`` for NCCL, else ``"cpu"``), which moves no tensor.

    Contract on ``pgm``: the padded edge count splits into even-sized
    slices (``E % n == 0`` and ``E/n`` even) with reverse pairs on one rank.
    ``run_bp_sharded`` re-pads a single graph; a bucket's folded ``B*E``
    (a multiple of ``EDGE_PAD = 128``) splits over any power-of-two mesh of
    at most 64 ranks."""
    if mesh is None:
        require_world()
        mesh = make_bp_mesh(axis=axis,
                            device=_mesh_device(dist.get_backend()))
    n, rank, group = mesh_axis(mesh, axis)

    def update_fn(pgm: PGM, logm: torch.Tensor):
        e, s = logm.shape
        if e % n or (e // n) % 2:
            raise ValueError(
                f"edge axis {e} does not split into even shards over "
                f"{n} devices; pad with pad_pgm (run_bp_sharded does this)")
        plan = _plan(pgm, n, rank)
        lo, hi = plan.lo, plan.hi
        vsum = rank_order_sum(comm.all_gather(
            M.fold_in_edges(plan.in_edges, plan.in_mask, logm), group))
        src = pgm.edge_src[lo:hi]
        pre = pgm.log_psi_v[src] + vsum[src] - logm[pgm.edge_rev[lo:hi]]
        pre = torch.where(pgm.state_mask[src], pre, NEG_INF)
        cand_s, resid_s = slice_update(pgm.log_psi_e[lo:hi], pre,
                                       logm[lo:hi], pgm.dst_mask[lo:hi],
                                       pgm.edge_mask[lo:hi])
        cand = logm.new_empty((e, s))
        resid = logm.new_empty((e,))
        comm.all_gather_into(cand, cand_s, group)
        comm.all_gather_into(resid, resid_s, group)
        return cand, resid

    update_fn.mesh = mesh             # the engine's bucket fold reads these
    update_fn.axis = axis
    return update_fn


def make_sharded_engine(scheduler, mesh=None, *, axis: str = BP_AXIS,
                        device="cuda", **config) -> BPEngine:
    """A ``BPEngine`` on ``device`` whose message update runs sharded over
    ``mesh``. ``scheduler`` is a ``Scheduler`` instance or registry spec
    string; ``config`` holds the remaining ``BPConfig`` fields (eps,
    max_rounds, damping, chunk_rounds, history, ...). Scheduler selection,
    the convergence vote and frontier commits run replicated on every rank,
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

    Call it on every rank with the same graph and a generator seeded alike.
    Returns the engine's ``BPResult`` (replicated on every rank):
    ``beliefs (V, S)``, ``logm (E', S)`` with ``E'`` the edge count re-padded
    to a multiple of ``2 * n`` (real edges keep their places), ``rounds``,
    ``converged``. Deterministic schedulers follow the one-device trajectory
    up to float reassociation in the per-vertex sum; stochastic ones draw
    the same numbers as a one-device run, since the generator lives in the
    replicated engine loop."""
    dev = resolve_device(device)
    n, _, _ = mesh_axis(mesh, axis)
    e = pgm.n_edges
    quantum = 2 * n
    need = -(-e // quantum) * quantum
    if need != e:
        pgm = pad_pgm(pgm, n_edges=need, n_vertices=pgm.n_vertices,
                      n_states=pgm.n_states_max)
    engine = make_sharded_engine(scheduler, mesh, axis=axis, device=dev,
                                 eps=eps, max_rounds=max_rounds,
                                 damping=damping, chunk_rounds=chunk_rounds,
                                 history=history)
    return engine.run(shard_pgm(pgm, mesh, axis=axis), rng)
