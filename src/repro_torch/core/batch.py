"""Batched multi-graph BP: padded buckets of graphs, stacked on one device.

The port of ``repro.core.batch``. A single sparse PGM rarely saturates a
many-core device; the serving workload is *many independent* inference
problems per device step. This module provides the batching primitive:

- ``BatchedPGM``: B same-shape graphs stacked field by field (every tensor
  of its ``pgm`` has a leading batch axis). The static ``n_real_*`` are the
  bucket's ceilings; each graph's own counts ride along as the (B,) tuples
  ``pgm.edge_count``/``pgm.vertex_count``, from which the schedulers size
  their frontiers.
- ``bucket_pgms``: groups heterogeneous graphs into buckets keyed by
  power-of-two (edge, state) ceilings, bounding padding waste at ~2x per
  axis, then pads each graph to its bucket shape.

The batched *loop* lives in ``repro_torch.core.engine``: the message update
runs on the bucket's *disjoint union* -- ``BatchedPGM.folded()`` offsets
vertex and edge ids so B graphs become one (B*E)-edge graph riding the
unmodified single-graph update, kernels included. The union is built once
per ``BatchedPGM`` and kept, as are the per-graph tensors the schedulers
read (``memo``). Under the ``"sharded"`` backend a bucket becomes
rank-resident (``repro_torch.dist.ShardBatch``): each rank keeps its flat
slice of the union's messages and pairwise tables, which may cross slot
boundaries (``folded(mesh=)`` gives that union for a whole bucket).

Randomness: the reference derives one key per graph with ``fold_in(rng,
input position)``. The port derives one ``torch.Generator`` per position
from a base seed with SplitMix64 (``slot_seed``), so results do not depend
on how a stream is bucketed; the numbers differ from JAX's threefry
(ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Mapping, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.core.graph import (_ARRAY_FIELDS, _DTYPES, EDGE_PAD, PGM,
                                    VERTEX_PAD, host_operands,
                                    pad_pgm_arrays)

__all__ = ["BatchedPGM", "Bucket", "RidgeEffort", "RoundsHistory",
           "batch_generators", "bucket_key", "bucket_pgms", "bucket_shape",
           "group_ceilings", "slot_generator", "slot_seed", "run_bp_batch",
           "run_bp_many"]

#: every tensor field of a ``PGM``, stacked along the batch axis
_TENSOR_FIELDS = _ARRAY_FIELDS + ("in_edges", "in_mask", "dst_mask")
_IN_FIELDS = ("in_edges", "in_mask")
_MASK64 = (1 << 64) - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _widen(t: torch.Tensor, width: int) -> torch.Tensor:
    """An in-edge table (``in_edges``/``in_mask``, columns last) padded to
    ``width`` columns: 0, and ``in_mask`` False, there. Always a new
    tensor."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _stack_rows(rows: Sequence[Mapping[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Stack per-graph tensor fields of one padded (E, V, S) shape along a
    new batch axis; the in-edge tables are widened to the widest."""
    width = max(r["in_edges"].shape[-1] for r in rows)
    return {k: torch.stack([_widen(r[k], width) if k in _IN_FIELDS else r[k]
                            for r in rows]) for k in _TENSOR_FIELDS}


def _host_rows(padded: Sequence[Mapping[str, np.ndarray]],
               device) -> List[Dict[str, torch.Tensor]]:
    """Padded per-graph reference fields (host numpy) with the port's
    derived operands (``graph.host_operands``), as tensors on
    ``device``."""
    return [{k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device=device, dtype=_DTYPES[k]) for k, v in host_operands(d).items()}
        for d in padded]


@dataclasses.dataclass(frozen=True)
class BatchedPGM:
    """B graphs padded to one (E, V, S) bucket shape, stacked field by field.

    ``pgm`` is a ``PGM`` whose tensors carry a leading batch axis --
    ``edge_src (B, E)``, ``log_psi_e (B, E, S, S)``, ``in_edges (B, V, D)``
    (D the bucket's widest in-degree) ... -- whose static ints are the
    bucket ceilings and whose ``edge_count``/``vertex_count`` are (B,)
    tuples of each graph's own counts. ``graph(i)`` is a standalone ``PGM``
    that reproduces graph ``i``'s batched trajectory bit for bit.
    """

    pgm: PGM
    _memo: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def size(self) -> int:
        """Number of graphs B."""
        return self.pgm.edge_src.shape[0]

    @property
    def n_edges(self) -> int:
        """Padded directed edge count per graph."""
        return self.pgm.edge_src.shape[1]

    @property
    def n_vertices(self) -> int:
        """Padded vertex count per graph (with its dummy)."""
        return self.pgm.log_psi_v.shape[1]

    @property
    def n_states_max(self) -> int:
        """Padded state count S."""
        return self.pgm.log_psi_v.shape[2]

    @property
    def device(self) -> torch.device:
        """The device every tensor of the bucket lives on."""
        return self.pgm.log_psi_e.device

    def memo(self, key, build: Callable[[], Any]):
        """``build()`` once per bucket and ``key``, then the kept value:
        the union, the TPU-layout operands, per-graph frontier sizes."""
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def per_graph(self, values: Sequence[int]) -> torch.Tensor:
        """(B,) int64 tensor on the bucket's device of host ints, one per
        graph (one host-to-device copy; callers keep it with ``memo``)."""
        return torch.tensor(list(values), dtype=torch.int64,
                            device=self.device)

    def real_vertices(self) -> torch.Tensor:
        """(B, V) bool: vertex ``u`` of graph ``b`` is one of its own
        ``vertex_count`` real vertices."""
        return self.memo("real_vertices", lambda: torch.arange(
            self.n_vertices, device=self.device)[None, :]
            < self.per_graph(self.pgm.vertex_count)[:, None])

    def graph(self, i: int) -> PGM:
        """Graph ``i`` as a standalone (bucket-padded) ``PGM``; its tensors
        are views of the bucket's."""
        p = self.pgm
        return PGM(**{k: getattr(p, k)[i] for k in _TENSOR_FIELDS},
                   n_real_vertices=p.n_real_vertices,
                   n_real_edges=p.n_real_edges,
                   edge_count=p.edge_count[i], vertex_count=p.vertex_count[i])

    def folded(self, mesh=None, *, axis: str = "bp") -> PGM:
        """The bucket as one disjoint-union PGM with B*E edges and B*V
        vertices: graph ``b``'s vertex ``u`` becomes ``b*V + u`` and its
        edge ``e`` becomes ``b*E + e`` (in ``edge_rev`` and ``in_edges``
        too). Message updates on the union are bitwise those of the member
        graphs -- no cross edges, and each vertex folds its in-edges in the
        same order -- so the whole bucket rides the single-graph update in
        one launch. Built once per bucket and kept.

        With ``mesh`` (a 1-D ``DeviceMesh`` whose axis is ``axis``, see
        ``repro_torch.dist``) the result is this rank's rank-resident union
        (``dist.shard_pgm`` of it: the rank's slice of the pairwise tables,
        kept too); the union must split into even, pair-aligned slices
        over the mesh -- a ``ValueError`` otherwise. Per-graph E is a
        multiple of EDGE_PAD and reverse pairs sit at adjacent even
        indices, so any even per-rank split of B*E keeps reverse pairs on
        one rank."""
        union = self.memo("folded", self._fold)
        if mesh is None:
            return union
        from repro_torch.dist import mesh_axis, shard_pgm
        n, rank, _ = mesh_axis(mesh, axis)
        return self.memo(("folded", axis, n, rank),
                         lambda: shard_pgm(union, mesh, axis=axis))

    @spans.traced("bp.fold")
    def _fold(self) -> PGM:
        p = self.pgm
        b, e, v, s = self.size, self.n_edges, self.n_vertices, \
            self.n_states_max
        rows = torch.arange(b, dtype=torch.int32, device=self.device)
        off_v, off_e = (rows * v)[:, None], (rows * e)[:, None]
        return PGM(
            edge_src=(p.edge_src + off_v).reshape(-1),
            edge_dst=(p.edge_dst + off_v).reshape(-1),
            edge_rev=(p.edge_rev + off_e).reshape(-1),
            edge_mask=p.edge_mask.reshape(-1),
            log_psi_e=p.log_psi_e.reshape(b * e, s, s),
            log_psi_v=p.log_psi_v.reshape(b * v, s),
            state_mask=p.state_mask.reshape(b * v, s),
            n_states=p.n_states.reshape(-1),
            in_edges=(p.in_edges + off_e[:, :, None]).reshape(b * v, -1),
            in_mask=p.in_mask.reshape(b * v, -1),
            dst_mask=p.dst_mask.reshape(b * e, s),
            n_real_vertices=b * v, n_real_edges=b * e,
            edge_count=b * e, vertex_count=b * v)

    def folded_update(self, update_fn: Callable, logm: torch.Tensor, *,
                      mesh=None, axis: str = "bp"):
        """A single-graph update ``(pgm, logm) -> (cand, resid)`` run once
        on the union (``folded(mesh, axis=axis)``): (B, E, S) messages in,
        ``(cand (B, E, S), resid (B, E))`` out. On a rank-resident union
        the messages are the rank's flat (B*E/n, S) slice, and so is
        ``cand``; ``resid`` is whole."""
        union = self.folded(mesh, axis=axis)
        if getattr(union, "rank_resident", False):
            cand, resid = update_fn(union, logm)
            return cand, resid.reshape(self.size, self.n_edges)
        b, e, s = logm.shape
        cand, resid = update_fn(union, logm.reshape(b * e, s))
        return cand.reshape(b, e, s), resid.reshape(b, e)

    def take(self, indices) -> "BatchedPGM":
        """Narrow the batch to the given slot ``indices`` (the compaction
        primitive). Ceilings are kept, so the kept graphs' trajectories are
        untouched."""
        idx = [int(i) for i in indices]
        sel = torch.tensor(idx, dtype=torch.int64, device=self.device)
        p = self.pgm
        return BatchedPGM(pgm=dataclasses.replace(
            p, **{k: getattr(p, k).index_select(0, sel)
                  for k in _TENSOR_FIELDS},
            edge_count=tuple(p.edge_count[i] for i in idx),
            vertex_count=tuple(p.vertex_count[i] for i in idx)))

    def with_graph(self, j: int, graph: PGM) -> "BatchedPGM":
        """A new bucket with slot ``j`` holding ``graph`` (padded to the
        bucket's shape; its own counts must fit the bucket's ceilings).
        The other slots are copied unchanged. A graph that already has the
        bucket's padded shape is written on the device as it is (the
        serving path's backfill); any other is padded on the host first."""
        p = self.pgm
        if graph.device != self.device:
            raise ValueError(f"graph is on {graph.device}, bucket on "
                             f"{self.device}")
        row = self.slot_row(graph)
        width = max(row["in_edges"].shape[1], p.in_edges.shape[2])
        fields = {}
        for k in _TENSOR_FIELDS:
            full, one = getattr(p, k), row[k]
            if k in _IN_FIELDS:
                full, one = _widen(full, width), _widen(one, width)
            else:
                full = full.clone()
            full[j] = one
            fields[k] = full
        counts = lambda old, new: old[:j] + (int(new),) + old[j + 1:]
        return BatchedPGM(pgm=dataclasses.replace(
            p, **fields, edge_count=counts(p.edge_count, graph.edge_count),
            vertex_count=counts(p.vertex_count, graph.vertex_count)))

    def slot_row(self, graph: PGM) -> Dict[str, torch.Tensor]:
        """``graph``'s tensor fields padded to the bucket's shape, on the
        bucket's device (its own tensors when it has that shape already;
        else padded on the host). Its own counts must fit the bucket's
        ceilings (a ``ValueError`` otherwise)."""
        p = self.pgm
        if graph.edge_count > p.n_real_edges or \
                graph.vertex_count > p.n_real_vertices:
            raise ValueError(
                f"graph's counts ({graph.edge_count} edges, "
                f"{graph.vertex_count} vertices) exceed the bucket's "
                f"ceilings ({p.n_real_edges}, {p.n_real_vertices})")
        if (graph.n_edges, graph.n_vertices, graph.n_states_max) == (
                self.n_edges, self.n_vertices, self.n_states_max):
            return {k: getattr(graph, k).to(self.device)
                    for k in _TENSOR_FIELDS}
        return _host_rows([pad_pgm_arrays(
            graph, n_edges=self.n_edges, n_vertices=self.n_vertices,
            n_states=self.n_states_max)], self.device)[0]

    @classmethod
    def from_pgms(cls, pgms: Sequence[PGM], *,
                  n_edges: int | None = None,
                  n_vertices: int | None = None,
                  n_states: int | None = None,
                  n_real_edges: int | None = None,
                  n_real_vertices: int | None = None) -> "BatchedPGM":
        """Pad ``pgms`` to their joint max (E, V, S) shape -- or the given
        explicit ceilings -- and stack, on the graphs' (common) device.

        Graphs that already have that shape (the serving path's staged
        elements) are stacked on the device as they are; otherwise padding
        runs on the host in numpy (the reference's arrays, bitwise). Both
        give the same tensors."""
        if len(pgms) == 0:
            raise ValueError("empty batch")
        dev = pgms[0].device
        if any(p.device != dev for p in pgms):
            raise ValueError("graphs of one batch must share a device")
        e_b = n_edges or max(p.n_edges for p in pgms)
        v_b = n_vertices or max(p.n_vertices for p in pgms)
        s_b = n_states or max(p.n_states_max for p in pgms)
        if all((p.n_edges, p.n_vertices, p.n_states_max) == (e_b, v_b, s_b)
               for p in pgms):
            rows = [{k: getattr(p, k) for k in _TENSOR_FIELDS} for p in pgms]
        else:
            rows = _host_rows([pad_pgm_arrays(p, n_edges=e_b, n_vertices=v_b,
                                              n_states=s_b) for p in pgms],
                              dev)
        return cls(pgm=PGM(
            **_stack_rows(rows),
            n_real_vertices=(n_real_vertices
                             or max(p.n_real_vertices for p in pgms)),
            n_real_edges=(n_real_edges
                          or max(p.n_real_edges for p in pgms)),
            edge_count=tuple(p.edge_count for p in pgms),
            vertex_count=tuple(p.vertex_count for p in pgms)))


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One shape-homogeneous batch plus the input positions it came from."""
    indices: Tuple[int, ...]
    batch: BatchedPGM


def bucket_key(pgm: PGM, growth: float = 2.0) -> tuple:
    """Bucket shape key: (growth-factor ceiling of the padded edge count,
    pow2-ceil state count). Graphs sharing a key share a padded bucket
    shape."""
    if not growth > 1.0:
        raise ValueError(f"growth must be > 1 (got {growth}); use 2.0 for "
                         "pow2 buckets or math.inf for a single bucket")
    e = _round_up(max(pgm.n_real_edges, 1), EDGE_PAD)
    if math.isinf(growth):
        ekey = 0
    elif growth == 2.0:
        ekey = _pow2_ceil(e)
    else:
        ekey = math.ceil(math.log(e, growth) - 1e-9)
    return (ekey, _pow2_ceil(pgm.n_states_max))


def bucket_shape(pgm: PGM, growth: float = 2.0) -> tuple[int, int, int,
                                                         int, int]:
    """Per-request deterministic padded-shape ceilings for *online*
    bucketing: ``(n_edges, n_vertices, n_states, n_real_edges,
    n_real_vertices)``. They depend only on the request itself -- the edge
    axis takes its ``growth``-factor ceiling (as ``bucket_key``), the
    vertex and state axes their pow2 ceilings -- and the static real-count
    ceilings are set to the padded ceilings. Requires finite ``growth``."""
    if not growth > 1.0 or math.isinf(growth):
        raise ValueError("online bucketing needs finite growth > 1, got "
                         f"{growth}")
    e = max(_round_up(max(pgm.n_real_edges, 1), EDGE_PAD), pgm.n_edges)
    if growth == 2.0:
        e_c = _pow2_ceil(e)
    else:
        k = math.ceil(math.log(e, growth) - 1e-9)
        e_c = max(_round_up(int(math.ceil(growth ** k)), EDGE_PAD), e)
    v_c = _pow2_ceil(max(_round_up(pgm.n_real_vertices + 1, VERTEX_PAD),
                         pgm.n_vertices))
    s_c = _pow2_ceil(pgm.n_states_max)
    return (e_c, v_c, s_c, e_c, v_c)


def group_ceilings(pgms: Sequence[PGM]) -> tuple[int, int, int, int, int]:
    """Joint padded-shape and static-metadata ceilings over a graph group:
    ``(n_edges, n_vertices, n_states, n_real_edges, n_real_vertices)``."""
    return (max(p.n_edges for p in pgms),
            max(p.n_vertices for p in pgms),
            max(p.n_states_max for p in pgms),
            max(p.n_real_edges for p in pgms),
            max(p.n_real_vertices for p in pgms))


def bucket_pgms(pgms: Sequence[PGM], *,
                growth: float = 2.0,
                max_batch: int | None = None) -> List[Bucket]:
    """Group heterogeneous graphs into padded, shape-homogeneous buckets.

    Bucket key = (growth-factor ceiling of the padded edge count, pow2-ceil
    state count): within a bucket no graph pays more than ~``growth``x
    padding on the edge axis (the dominant cost, ``log_psi_e`` is E*S^2) or
    ~2x on the state axis; the vertex axis takes the bucket max.
    ``max_batch`` caps graphs per bucket (a device-memory guard).
    """
    keyed: dict[tuple, List[int]] = {}
    for i, p in enumerate(pgms):
        keyed.setdefault(bucket_key(p, growth), []).append(i)
    buckets = []
    for key in sorted(keyed):
        idx = keyed[key]
        chunks = ([idx] if not max_batch else
                  [idx[i:i + max_batch] for i in range(0, len(idx), max_batch)])
        for chunk in chunks:
            batch = BatchedPGM.from_pgms([pgms[i] for i in chunk])
            buckets.append(Bucket(indices=tuple(chunk), batch=batch))
    return buckets


def slot_seed(base: int, i: int) -> int:
    """The seed of input position ``i``'s generator under base seed
    ``base``: SplitMix64's output for state ``base + (i + 1) * golden``,
    a 64-bit int. Stands in for the reference's ``fold_in(rng, i)``."""
    z = (int(base) + (int(i) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def slot_generator(base: int, i: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with
    ``slot_seed(base, i)``."""
    return torch.Generator(device=device).manual_seed(slot_seed(base, i))


def batch_generators(rng, size: int, device) -> List[torch.Generator]:
    """(B,) per-graph generators: a sequence of B generators passes
    through; one ``torch.Generator`` (or an int) is a base seed, and slot
    ``i`` gets ``slot_generator(base, i)``. (The reference's
    ``batch_keys``.)"""
    if isinstance(rng, (torch.Generator, int)):
        base = rng.initial_seed() if isinstance(rng, torch.Generator) else rng
        return [slot_generator(base, i, device) for i in range(size)]
    gens = list(rng)
    if len(gens) != size or not all(isinstance(g, torch.Generator)
                                    for g in gens):
        raise ValueError(f"need one torch.Generator per graph ({size}), or "
                         "one base generator or seed")
    return gens


class RidgeEffort:
    """Tiny incrementally-fit ridge regression predicting rounds-to-converge.

    The learned half of effort calibration: each completed request
    contributes one ``(features, rounds)`` observation via normal-equation
    accumulators (``A^T A`` / ``A^T y``, O(d^2) per fit, d = ``DIM``), and
    ``predict`` solves the l2-regularized system lazily. Features come from
    :meth:`features`: a bias, the admission score (residual-at-admit), the
    log-scaled edge/state ceilings mined from the kind tuple, and up to two
    caller-supplied extras (the deadline policy passes coupling-strength
    stats). Because size enters as a *feature* rather than a table key, one
    global model generalizes across kinds -- an unseen bucket shape gets a
    prediction from the first observation of any other shape, which the
    nearest-neighbor table it replaces never could.

    ``to_dict``/``from_dict`` round-trip the accumulators exactly (JSON-safe
    nested lists), so a warm effort model can ship with a deployment spec.
    Not internally locked: :class:`RoundsHistory` serializes access."""

    #: feature dimension: [1, score, log1p(edges), log1p(states), extra0,
    #: extra1]
    DIM = 6

    def __init__(self, l2: float = 1.0):
        if l2 <= 0:
            raise ValueError(f"l2 must be > 0, got {l2}")
        self.l2 = float(l2)
        self._ata = np.zeros((self.DIM, self.DIM), dtype=np.float64)
        self._aty = np.zeros(self.DIM, dtype=np.float64)
        self._n = 0
        self._w: np.ndarray | None = None

    @staticmethod
    def features(kind, score: float,
                 extra: Sequence[float] = ()) -> np.ndarray:
        """The fixed-width feature vector for one request: ``[1, score,
        log1p(edge ceiling), log1p(state ceiling), extra...]``, zero-padded
        to ``DIM``. Numeric leaves are mined from the (possibly nested)
        ``kind`` tuple -- serving kinds are ``bucket_shape`` ceilings
        ``(E, V, S, rE, rV)``, router kinds wrap them in ``("routed", ...)``
        -- with non-numeric leaves skipped, so any hashable kind works."""
        nums: List[float] = []

        def walk(x):
            if isinstance(x, bool):
                return
            if isinstance(x, (int, float, np.integer, np.floating)):
                nums.append(float(x))
            elif isinstance(x, (tuple, list)):
                for y in x:
                    walk(y)

        walk(kind)
        f = [1.0, float(score)]
        f += [float(np.log1p(abs(nums[i]))) for i in (0, 2)
              if i < len(nums)]                    # edge / state ceilings
        f += [float(v) for v in list(extra)[:RidgeEffort.DIM - len(f)]]
        f += [0.0] * (RidgeEffort.DIM - len(f))
        return np.asarray(f[:RidgeEffort.DIM], dtype=np.float64)

    @property
    def n_observations(self) -> int:
        """Observations fitted so far."""
        return self._n

    def fit_one(self, x: np.ndarray, y: float) -> None:
        """Accumulate one observation (features ``x``, observed rounds
        ``y``) into the normal equations; invalidates the cached solve."""
        x = np.asarray(x, dtype=np.float64)
        self._ata += np.outer(x, x)
        self._aty += float(y) * x
        self._n += 1
        self._w = None

    def predict(self, x: np.ndarray) -> float | None:
        """Predicted rounds for features ``x`` (clipped at 0; ``None``
        until at least two observations were fitted -- one point cannot
        anchor a slope)."""
        if self._n < 2:
            return None
        if self._w is None:
            self._w = np.linalg.solve(
                self._ata + self.l2 * np.eye(self.DIM), self._aty)
        return max(float(np.dot(x, self._w)), 0.0)

    def to_dict(self) -> dict:
        """JSON-ready accumulator state (exact round-trip)."""
        return {"l2": self.l2, "n": self._n,
                "ata": self._ata.tolist(), "aty": self._aty.tolist()}

    @classmethod
    def from_dict(cls, d: Mapping) -> "RidgeEffort":
        """Rebuild a model from :meth:`to_dict` output."""
        m = cls(l2=float(d["l2"]))
        m._n = int(d["n"])
        m._ata = np.asarray(d["ata"], dtype=np.float64)
        m._aty = np.asarray(d["aty"], dtype=np.float64)
        return m


class RoundsHistory:
    """Bounded, thread-safe effort calibration: per-kind observations plus
    (by default) a learned :class:`RidgeEffort` predictor over them.

    A *kind* is any hashable key naming a family of similar requests -- the
    serving layer uses the bucket-shape ceilings (``bucket_shape`` /
    ``group_ceilings`` tuples), so graphs that share a padded shape share a
    history. ``observe(kind, score, rounds)`` records one finished request's
    (admission score, rounds actually run); ``expect(kind, score)`` predicts
    the rounds a new request will need; ``mean(kind)`` is the score-free
    aggregate the router tier uses for effort-in-flight load estimates.

    ``predictor`` picks the expectation model: ``"ridge"`` (default) fits
    one incremental :class:`RidgeEffort` regression over (score, size, extra)
    features of *every* observation -- cross-kind generalization, so unseen
    shapes stop cold-starting -- while ``"nearest"`` is the original
    per-kind nearest-recorded-score lookup. Both fall back, in order, to
    the kind's nearest observation, the constructor ``prior`` (the
    prior-seeding knob: a deployment's known typical rounds), and finally
    the caller's ``default=`` -- so callers no longer need a ``None``
    branch. ``capacity`` bounds observations kept per kind (a deque, so
    drifting workloads age out), keeping host memory O(kinds) on
    indefinitely long streams.

    This is the feedback half of Residual-BP-style admission (the
    reference's ``ResidualAdmission`` and ``deadline`` policies, whose
    serving layer is ROADMAP queue 1, item 9): the cheap residual-at-admit
    proxy orders requests, and this history calibrates that proxy into
    expected effort from what actually happened to similar requests.

    All methods lock, so one instance may be shared across serving
    threads, pooling effort calibration instead of cold-starting it per
    replica."""

    def __init__(self, capacity: int = 64, *, predictor: str = "ridge",
                 prior: float | None = None, l2: float = 1.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if predictor not in ("ridge", "nearest"):
            raise ValueError(
                f"predictor must be 'ridge' or 'nearest', got {predictor!r}")
        self.capacity = capacity
        self.predictor = predictor
        self.prior = None if prior is None else float(prior)
        self._model = RidgeEffort(l2=l2) if predictor == "ridge" else None
        self._hist: Dict[Any, Deque[Tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def observe(self, kind, score: float, rounds: float,
                extra: Sequence[float] = ()) -> None:
        """Record one completed request of ``kind``: its admission score,
        the rounds it actually ran before release, and optional extra
        feature values (coupling stats) for the learned predictor."""
        with self._lock:
            dq = self._hist.get(kind)
            if dq is None:
                dq = self._hist[kind] = deque(maxlen=self.capacity)
            dq.append((float(score), float(rounds)))
            if self._model is not None:
                self._model.fit_one(
                    RidgeEffort.features(kind, score, extra), rounds)

    def _nearest(self, kind, score: float) -> float | None:
        dq = self._hist.get(kind)
        if not dq:
            return None
        return min(dq, key=lambda sr: abs(sr[0] - float(score)))[1]

    def expect(self, kind, score: float, *, default: float | None = None,
               extra: Sequence[float] = ()) -> float | None:
        """Expected rounds for a new request of ``kind`` with admission
        ``score``: the ridge prediction when the model has data (any kind's
        data -- size is a feature), else the kind's nearest recorded score,
        else the seeded ``prior``, else ``default``. Callers that always
        need a number pass ``default=`` instead of branching on ``None``."""
        with self._lock:
            if self._model is not None:
                est = self._model.predict(
                    RidgeEffort.features(kind, score, extra))
                if est is not None:
                    return est
            est = self._nearest(kind, score)
            if est is not None:
                return est
            return self.prior if self.prior is not None else default

    def mean(self, kind=None, *, default: float | None = None
             ) -> float | None:
        """Mean observed rounds across every record of ``kind`` -- the
        score-free effort estimate for callers with no admission score at
        hand (request routing). An unseen kind falls back to the global
        mean over *all* kinds (``kind=None`` asks for that directly), then
        the seeded ``prior``, then ``default``."""
        with self._lock:
            if kind is not None:
                dq = self._hist.get(kind)
                if dq:
                    return sum(r for _, r in dq) / len(dq)
            total = n = 0.0
            for dq in self._hist.values():
                total += sum(r for _, r in dq)
                n += len(dq)
            if n:
                return total / n
            return self.prior if self.prior is not None else default

    def to_dict(self) -> dict:
        """JSON-ready snapshot: config, per-kind observations (kinds keyed
        by ``repr``), and the ridge accumulators. Round-trips through
        :meth:`from_dict` to a history with identical predictions."""
        with self._lock:
            return {
                "capacity": self.capacity, "predictor": self.predictor,
                "prior": self.prior,
                "model": None if self._model is None
                else self._model.to_dict(),
                "hist": [[repr(k), [list(sr) for sr in dq]]
                         for k, dq in self._hist.items()],
            }

    @classmethod
    def from_dict(cls, d: Mapping) -> "RoundsHistory":
        """Rebuild a history from :meth:`to_dict` output. Kind keys were
        serialized by ``repr`` and are restored via ``ast.literal_eval``
        (serving kinds are literal tuples); non-literal kinds keep their
        repr string as the key -- predictions still work, size features
        simply read as absent."""
        import ast
        h = cls(capacity=int(d["capacity"]), predictor=d["predictor"],
                prior=d.get("prior"))
        if d.get("model") is not None:
            h._model = RidgeEffort.from_dict(d["model"])
        for krepr, obs in d.get("hist", ()):
            try:
                kind = ast.literal_eval(krepr)
            except (ValueError, SyntaxError):
                kind = krepr
            dq = deque(maxlen=h.capacity)
            dq.extend((float(s), float(r)) for s, r in obs)
            h._hist[kind] = dq
        return h

    def __len__(self) -> int:
        with self._lock:
            return sum(len(dq) for dq in self._hist.values())


def __getattr__(name: str):
    # The deprecated wrappers live in ``runner``, which imports this module;
    # the reference exports them from here, so they resolve here too.
    if name in ("run_bp_batch", "run_bp_many"):
        from repro_torch.core import runner
        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
