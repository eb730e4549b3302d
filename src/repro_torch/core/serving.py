"""Asynchronous BP serving: online request streams, double-buffered bucket
slots, prefetch staging, bucket compaction, admission policies and SLA
eviction.

The port of ``repro.core.serving``. ``BPEngine.serve`` makes the engine a
scheduler one level up: it decides which graphs occupy device slots each
chunk. This module is the pipeline behind it:

- **online streams**: requests arrive from any iterator. Arrivals are
  *staged* -- padded to their group's ceilings on the host in numpy, then
  copied early to the engine's device. On a GPU the copy starts from
  pinned host memory with ``non_blocking=True`` on one dedicated copy
  stream and records an event; the compute stream waits on that event
  before the element's first use (admission, backfill, staged eviction),
  and the element's tensors are ``record_stream``-ed there so the caching
  allocator does not hand their memory back to the copy stream early.
- **slots**: up to ``slots`` resident buckets are stepped per cycle, in the
  reference's order: every slot steps, then the host pulls and stages new
  arrivals, then each slot syncs and is serviced (evacuation, backfill,
  compaction). The port's ``BPEngine.step`` is a host loop that reads
  ``done`` every ``SYNC_ROUNDS`` rounds, so two slots run one after the
  other rather than overlapped by asynchronous dispatch (ROADMAP queue 2b);
  results, sweep accounting and virtual-time timelines follow the cycle
  order, not the overlap.
- **bucket compaction**: once a group's queue has drained and the stream is
  exhausted, survivors re-bucket into a narrower batch (power-of-two
  widths), removing the dead-slot sweeps that evacuation alone cannot.
- **admission policies**: ``"fifo"`` (default), ``"residual"``
  (co-batch similar expected effort), ``"windowed"`` (hold a bucket open
  to fill it) and ``"deadline"`` (per-request latency budgets, slack
  ordering, slot packing, mid-flight and staged eviction), through the
  ``ADMISSION_POLICIES`` registry.
- **threaded ingestion**: ``ingest_threads=N`` moves the stream pull onto
  feeder threads behind a bounded queue. Feeder threads only pull from the
  source iterator; every torch call but one stays on the serving thread.
- **on a mesh** (the sharded backend): every rank of the mesh runs the
  pipeline on the same stream; the mesh's rank 0 takes every timing-driven
  decision and publishes it to the others at most twice a cycle, and
  staged requests stay on the host (each rank places only its slice); see
  :class:`ServingPipeline`.
- **graphs made on the card**: a request may arrive as a graph on the GPU,
  written by kernels on whatever stream its producer used (another
  thread's, under the router tier). Where a request enters -- the feeder's
  or the serving thread's pull -- an event is recorded on the pulling
  thread's current stream (the one call above), and staging makes its own
  stream wait on that event before it reads the graph to the host. The
  alternative, synchronizing the producer's stream at submission, would
  block the submitting thread on every request; the event blocks nothing
  but the one host read that needs the graph finished.

Trajectory invariance is the load-bearing property: request ``rid`` draws
from ``slot_generator(base, rid)`` and its trajectory depends only on its
padded shape and that generator (a bucket's slots are bitwise their solo
runs), so neither the slot count, nor backfill order, nor admission
policy, nor compaction changes any result bit. On a materialized
``Sequence`` the pipeline pads with ``serve``'s group ceilings, so
``serve_async`` is bitwise ``BPEngine.serve``, and both are bitwise
``run_many`` on same-shape groups. The draws are not JAX's threefry
(ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import heapq
import queue as _queue
import threading
import time
from collections import deque
from typing import (Any, Deque, Dict, Iterable, Iterator, List, Mapping,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.batch import (_TENSOR_FIELDS, BatchedPGM,
                                    RoundsHistory, _pow2_ceil, bucket_key,
                                    bucket_shape, group_ceilings,
                                    slot_generator)
from repro_torch.core.engine import BPEngine, BPResult, BPState, ServeStats
from repro_torch.core.graph import (NEG_INF, PGM, host_operands,
                                    pad_pgm_arrays)
from repro_torch.core.registry import Registry

__all__ = ["ADMISSION_POLICIES", "AdmissionPolicy", "AsyncServeResult",
           "AsyncServeStats", "DeadlineAdmission", "FIFOAdmission",
           "RequestRecord", "ResidualAdmission", "ServingPipeline",
           "SweepClock", "WindowedAdmission", "get_admission_policy",
           "list_admission_policies", "register_admission_policy",
           "serve_async"]


# --------------------------------------------------------------- records --

@dataclasses.dataclass
class RequestRecord:
    """One served request: its ``BPResult`` plus the host-side timeline.

    ``t_enqueue`` is when the request was pulled from the stream,
    ``t_admit`` when it was loaded into a resident bucket slot, ``t_done``
    when its result was released after a chunk sync (pipeline-clock
    seconds, ``perf_counter`` by default). ``latency_s`` is the serving
    metric: queue-in to result release.

    ``status`` is ``"completed"`` for the normal release path and
    ``"evicted"`` when the admission policy gave up on the request; an
    evicted record carries the request's *partial* result (beliefs at the
    messages it reached, ``converged=False``). A request evicted before it
    entered a bucket has ``t_admit == t_done`` and prior beliefs.
    ``slo_s`` is the request's latency budget from the stream (``None`` =
    no deadline)."""

    rid: int                    # input position (also its generator's index)
    result: BPResult
    t_enqueue: float
    t_admit: float
    t_done: float
    slo_s: float | None = None
    status: str = "completed"

    @property
    def latency_s(self) -> float:
        """Queue-in -> result-release latency, seconds."""
        return self.t_done - self.t_enqueue

    @property
    def evicted(self) -> bool:
        """True when the policy gave up on this request before it finished
        (``status == "evicted"``); the result is partial."""
        return self.status == "evicted"

    @property
    def deadline(self) -> float | None:
        """Absolute completion deadline in pipeline-clock seconds
        (``t_enqueue + slo_s``), or ``None`` without an SLO."""
        return None if self.slo_s is None else self.t_enqueue + self.slo_s

    @property
    def within_slo(self) -> bool:
        """Did this request complete within its latency budget? Requests
        without an SLO count as within; evicted ones never do."""
        if self.status != "completed":
            return False
        return self.slo_s is None or self.latency_s <= self.slo_s

    @property
    def queue_s(self) -> float:
        """Time spent waiting for a bucket slot, seconds."""
        return self.t_admit - self.t_enqueue

    @property
    def service_s(self) -> float:
        """Time resident in a bucket slot, seconds."""
        return self.t_done - self.t_admit


@dataclasses.dataclass
class AsyncServeStats(ServeStats):
    """``ServeStats`` plus the async pipeline's own accounting.

    ``compactions`` counts re-bucketing events (``compaction_log`` records
    ``(chunk index, width before, width after)`` for each);
    ``buckets_opened`` counts slot admissions, and ``staged`` counts
    requests pulled from the stream and copied to the device. ``policy``
    names the admission policy; ``admission_holds`` counts admission checks
    the policy deferred; ``admission_widths`` logs the width of every
    opened bucket (suppressed by ``record_events=False``).

    Eviction accounting: ``evictions`` counts requests released with
    ``status="evicted"`` (mid-flight and expired-while-staged),
    ``evicted_sweeps`` the device sweeps those requests had consumed (a
    subset of ``useful_sweeps``), and ``eviction_log`` records
    ``(chunk index, rid)`` per event."""

    compactions: int = 0
    #: (chunk index, width before, width after) per compaction event
    compaction_log: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    buckets_opened: int = 0
    staged: int = 0
    policy: str = "fifo"
    admission_holds: int = 0
    #: width of each opened bucket, in admission order
    admission_widths: List[int] = dataclasses.field(default_factory=list)
    evictions: int = 0
    evicted_sweeps: int = 0
    #: (chunk index, rid) per eviction event
    eviction_log: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class AsyncServeResult:
    """``serve_async`` output: per-request records in *completion* order
    plus pipeline stats. ``results`` re-sorts to input (rid) order."""

    records: List[RequestRecord]    # completion order
    stats: AsyncServeStats

    @property
    def results(self) -> List[BPResult]:
        """Per-request ``BPResult`` list indexed by rid. For the usual
        dense 0..n-1 rids this is input order; streams that supplied sparse
        explicit rids leave ``None`` gaps at the unused positions (rejected
        beyond a small sparsity factor -- use ``.records`` there)."""
        n = 1 + max((rec.rid for rec in self.records), default=-1)
        if n > 4 * len(self.records) + 64:
            raise ValueError(
                f"rids too sparse for a dense results list (max rid {n - 1} "
                f"over {len(self.records)} records); use .records instead")
        out: List[BPResult | None] = [None] * n
        for rec in self.records:
            out[rec.rid] = rec.result
        return out  # type: ignore[return-value]

    def latency_percentiles(
            self, qs: Sequence[float] = (50, 95, 99), *,
            field: str = "latency",
            status: str | None = None) -> Dict[str, float]:
        """Latency percentiles in ms, ``{"p50": ...}`` (NaN entries when no
        matching requests were served). ``field`` selects the timeline
        component: ``"latency"`` (queue-in -> result), ``"admission"``
        (queue-in -> admit) or ``"service"`` (admit -> result). ``status``
        filters the records: ``"completed"`` / ``"evicted"`` / ``None``
        (all)."""
        attrs = {"latency": "latency_s", "admission": "queue_s",
                 "service": "service_s"}
        if field not in attrs:
            raise KeyError(f"field must be one of {sorted(attrs)}, "
                           f"got {field!r}")
        if status not in (None, "completed", "evicted"):
            raise ValueError("status must be None, 'completed' or 'evicted',"
                             f" got {status!r}")
        recs = self.records if status is None else \
            [r for r in self.records if r.status == status]
        if not recs:
            return {f"p{q:g}": float("nan") for q in qs}
        lat = np.array([getattr(r, attrs[field]) for r in recs]) * 1e3
        return {f"p{q:g}": float(np.percentile(lat, q)) for q in qs}


# ------------------------------------------------------------- internals --

@dataclasses.dataclass
class _Staged:
    """A request staged for admission: padded to its group's ceilings and
    on (or being copied to) the engine's device. ``key`` is the request's
    ``torch.Generator``; ``score`` the admission policy's effort estimate
    (0.0 under FIFO); ``passed_over`` counts takes that skipped this
    request while it was the queue head; ``slo`` the latency budget
    (seconds from ``t_enqueue``, ``None`` = no deadline) and ``extra`` the
    policy's feature tuple. ``copy`` is ``(event, pinned host tensors)``
    while the staging copy may still be in flight, ``None`` once the
    compute stream has waited on it."""
    rid: int
    elem: PGM
    key: Any
    t_enqueue: float
    score: float = 0.0
    passed_over: int = 0
    slo: float | None = None
    extra: Tuple[float, ...] = ()
    copy: Any = None


class _Group:
    """One shape family: fixed padded-shape ceilings + its pending queue
    (enqueue order; policies may remove from the middle, so the head is
    always the oldest *remaining* request). ``key`` names it in the
    pipeline's ``_groups`` (and in a leader's decisions)."""

    __slots__ = ("ceilings", "queue", "key")

    def __init__(self, ceilings: Tuple[int, int, int, int, int], key=None):
        self.ceilings = ceilings
        self.key = ceilings if key is None else key
        self.queue: Deque[_Staged] = deque()


@dataclasses.dataclass
class _AdmitMeta:
    """Host-side per-request metadata carried while resident in a slot."""
    t_enqueue: float
    t_admit: float
    score: float
    slo: float | None = None
    extra: Tuple[float, ...] = ()


@dataclasses.dataclass(eq=False)     # remove-by-identity from the slot list
class _Slot:
    """One resident bucket: its group, engine state, and host-side caches
    (live rid per batch slot, last-synced per-graph rounds, admit times)."""
    group: _Group
    state: BPState
    live: List[int | None]
    rounds_host: np.ndarray
    r_before: np.ndarray
    #: rid -> admit-time metadata (enqueue/admit times, score, slo)
    meta: Dict[int, _AdmitMeta]

    @property
    def width(self) -> int:
        return len(self.live)


def _narrow_state(state: BPState, idx: Sequence[int]) -> BPState:
    """Gather batch slots ``idx`` out of a bucket's ``BPState`` (the
    compaction primitive): the graph (``BatchedPGM.take``), messages,
    scheduler carry, generator states and every counter are taken along
    the batch axis, so each kept graph's trajectory continues bit for bit
    in the narrower bucket."""
    idx = [int(i) for i in idx]
    ia = torch.tensor(idx, dtype=torch.int64, device=state.logm.device)
    take = lambda x: x.index_select(0, ia)                    # noqa: E731
    if getattr(state.graph, "rank_resident", False):
        # a rank's flat slice: the narrower union splits anew (collective)
        graph, logm = state.graph.narrow(state.logm, idx)
    else:
        graph, logm = state.graph.take(idx), take(state.logm)
    sstate = state.sched_state
    return dataclasses.replace(
        state,
        graph=graph,
        logm=logm,
        sched_state=take(sstate) if isinstance(sstate, torch.Tensor)
        else sstate,
        rng=tuple(state.rng[i] for i in idx),
        rounds=take(state.rounds),
        done=take(state.done),
        updates=take(state.updates),
        unconverged_history=take(state.unconverged_history),
        max_residual=take(state.max_residual))


# ----------------------------------------------------- admission policies --

def _residual_at_admit(arrs: Mapping[str, np.ndarray]) -> float:
    """Max L-inf residual of one BP step from uniform messages, computed
    host-side in numpy over the padded arrays ``pad_pgm_arrays`` produced.

    This is the paper's residual r(m) (Eq. 4) evaluated at the initial
    message state -- the quantity Residual BP prioritizes *messages* by,
    here evaluated once per *request* as its admission score. Numpy on the
    staging path, bitwise the reference's."""
    emask = np.asarray(arrs["edge_mask"])                      # (E,)
    smask = np.asarray(arrs["state_mask"])                     # (V, S)
    dst = np.asarray(arrs["edge_dst"])
    src = np.asarray(arrs["edge_src"])
    n_states = np.asarray(arrs["n_states"]).astype(np.float64)
    dst_mask = smask[dst]                                      # (E, S)
    logm = np.where(dst_mask, -np.log(n_states[dst])[:, None], NEG_INF)
    contrib = np.where(emask[:, None], logm, 0.0)
    vsum = np.zeros_like(smask, dtype=np.float64)
    np.add.at(vsum, dst, contrib)
    pre = (np.asarray(arrs["log_psi_v"]) + vsum)[src] \
        - logm[np.asarray(arrs["edge_rev"])]
    pre = np.where(smask[src], pre, NEG_INF)
    scores = np.asarray(arrs["log_psi_e"]) + pre[:, :, None]   # (E, S, S)
    m = np.maximum(scores.max(axis=1, keepdims=True), NEG_INF)
    cand = np.squeeze(m, 1) + np.log(
        np.maximum(np.exp(scores - m).sum(axis=1), 1e-38))
    x = np.where(dst_mask, cand, NEG_INF)
    mz = np.maximum(x.max(axis=1, keepdims=True), NEG_INF)
    z = np.squeeze(mz, 1) + np.log(np.maximum(
        np.where(dst_mask, np.exp(x - mz), 0.0).sum(axis=1), 1e-38))
    cand = np.where(dst_mask, cand - z[:, None], NEG_INF)
    d = np.where(dst_mask, np.abs(cand - logm), 0.0)
    resid = np.where(emask, d.max(axis=1), 0.0)
    return float(resid.max())


class AdmissionPolicy:
    """Base admission policy: *which staged request enters a bucket when*.

    The pipeline calls the hooks below at fixed points; the base
    implementations are exactly FIFO behavior, so a subclass overrides only
    the decisions it changes. Policies are addressable by string through
    ``ADMISSION_POLICIES`` (``get_admission_policy``), so
    ``BPConfig(admission="residual")`` stays serializable.

    Hooks (called on the serving thread):

    - ``score(pgm, arrs, group)`` -- per-request effort estimate at staging
      time (``arrs`` are the padded numpy arrays).
    - ``features(pgm, arrs, group)`` -- extra per-request feature values
      (coupling stats) for the learned effort model; default none.
    - ``ready(group, now)`` -- may a new bucket open from this group now?
    - ``pick_group(groups, now)`` -- which ready group admits when a slot
      frees; default cross-group FIFO by oldest staged head.
    - ``pick_many(groups, now, free)`` -- the groups to open buckets from
      this admission cycle, up to ``free``; default one ``pick_group``.
    - ``take(group, width, slot=None)`` -- remove and return up to
      ``width`` staged requests; ``slot`` is the bucket being backfilled.
    - ``cull(group, now)`` -- staged requests to give up on before
      admission (released as ``status="evicted"`` with prior beliefs).
    - ``should_evict(slot, rid, rounds, residual, now)`` -- mid-flight
      eviction after each chunk sync (only when ``evicts`` is True).
    - ``observe(group, score, rounds, service_s=...)`` -- completion
      feedback (not called for evicted requests).
    - ``forget(rid)`` -- the request left its slot.
    - ``pull_bonus()`` -- extra requests to pull beyond ``prefetch``.
    - ``wait_hint(groups, now)`` -- seconds the drive loop may sleep when
      nothing is admissible but work is staged.
    """

    name = "base"
    #: policies that may evict set this True; the pipeline then runs the
    #: cull/should_evict hooks at each sync (False skips that work).
    evicts = False

    def __init__(self):
        self.pipeline: "ServingPipeline | None" = None

    def bind(self, pipeline: "ServingPipeline") -> "AdmissionPolicy":
        """Attach to the driving pipeline (called once from its
        constructor); returns self. A policy instance holds
        pipeline-coupled state, so rebinding to another pipeline refuses:
        pass a registry spec string or a new instance per pipeline."""
        if self.pipeline is not None and self.pipeline is not pipeline:
            raise ValueError(
                f"{type(self).__name__} instance is already bound to a "
                "pipeline; admission policies are per-pipeline -- use a "
                "registry spec string or a fresh instance")
        self.pipeline = pipeline
        return self

    def score(self, pgm: PGM, arrs: Mapping[str, np.ndarray],
              group: _Group) -> float:
        """Effort estimate for one staged request; FIFO scores nothing."""
        return 0.0

    def features(self, pgm: PGM, arrs: Mapping[str, np.ndarray],
                 group: _Group) -> Tuple[float, ...]:
        """Extra per-request feature values for the learned effort model;
        the base policy computes none."""
        return ()

    def ready(self, group: _Group, now: float) -> bool:
        """May a fresh bucket open from ``group`` now? FIFO: always."""
        return True

    def pick_group(self, groups: Iterable[_Group], now: float):
        """The group to admit from: cross-group FIFO over ready groups
        (oldest staged head first), or ``None`` when nothing is
        admissible."""
        ready = [g for g in groups if g.queue and self.ready(g, now)]
        return min(ready, key=lambda g: g.queue[0].t_enqueue, default=None)

    def pick_many(self, groups: Iterable[_Group], now: float,
                  free: int) -> "List[_Group]":
        """The groups to open buckets from this admission cycle (at most
        ``free``). The default delegates to one :meth:`pick_group` call --
        one group per cycle, the FIFO cadence."""
        g = self.pick_group(groups, now)
        return [] if g is None else [g]

    def take(self, group: _Group, width: int,
             slot: "_Slot | None" = None) -> List[_Staged]:
        """Remove and return up to ``width`` staged requests from
        ``group``'s queue. FIFO pops the oldest."""
        return [group.queue.popleft()
                for _ in range(min(width, len(group.queue)))]

    def cull(self, group: _Group, now: float) -> List[_Staged]:
        """Staged requests to give up on before they are ever admitted;
        the base policy never culls."""
        return []

    def should_evict(self, slot: _Slot, rid: int, rounds: int,
                     residual: float, now: float) -> bool:
        """Mid-flight eviction decision for one live unfinished request;
        the base policy never evicts."""
        return False

    def observe(self, group: _Group, score: float, rounds: int,
                service_s: float = 0.0,
                extra: Tuple[float, ...] = ()) -> None:
        """Completion feedback for one released request; FIFO ignores it."""

    def forget(self, rid: int) -> None:
        """Request ``rid`` left its slot; drop any per-rid tracking."""

    def pull_bonus(self) -> int:
        """Extra pull target beyond ``prefetch`` (0 for FIFO)."""
        return 0

    def wait_hint(self, groups: Iterable[_Group], now: float) -> float:
        """Seconds the drive loop may sleep when work is staged but nothing
        is admissible (only a holding policy returns > 0)."""
        return 0.0


class FIFOAdmission(AdmissionPolicy):
    """Arrival-order admission -- the default: buckets open from the group
    whose staged head has waited longest, requests enter in enqueue order,
    backfill pops the oldest. Zero scoring cost."""

    name = "fifo"


class ResidualAdmission(AdmissionPolicy):
    """Expected-effort admission: co-batch requests that will run similarly
    long, so stragglers stop pinning buckets of already-finished peers.

    Every staged request is scored by its **residual at admit** (one numpy
    BP step from uniform messages), and a per-kind :class:`RoundsHistory`
    calibrates that proxy into expected rounds from what similar requests
    actually ran. A fresh bucket seeds with the *oldest* staged request and
    fills with the nearest expected-effort neighbors; backfill picks the
    staged request closest to the mean expected effort of the slot's live
    occupants.

    No-starvation: a fresh bucket always seeds with the oldest head, and a
    head skipped by ``aging`` consecutive takes is force-admitted next.
    ``history_capacity`` bounds per-kind feedback kept; an explicit
    ``history`` may be shared across pipelines."""

    name = "residual"

    def __init__(self, aging: int = 16, history_capacity: int = 64,
                 history: RoundsHistory | None = None):
        super().__init__()
        if aging < 1:
            raise ValueError(f"aging must be >= 1, got {aging}")
        self.aging = aging
        self.history = history if history is not None \
            else RoundsHistory(capacity=history_capacity)

    def score(self, pgm: PGM, arrs: Mapping[str, np.ndarray],
              group: _Group) -> float:
        return _residual_at_admit(arrs)

    def expected(self, group: _Group, score: float) -> float:
        """Expected rounds for an admission score: the history's prediction,
        falling back to the raw score before any feedback exists."""
        return self.history.expect(group.ceilings, score,
                                   default=float(score))

    def take(self, group: _Group, width: int,
             slot: "_Slot | None" = None) -> List[_Staged]:
        q = group.queue
        width = min(width, len(q))
        if width == 0:
            return []
        head = q[0]
        anchor = None
        forced = head.passed_over >= self.aging
        if slot is not None and not forced:
            live = [self.expected(group, slot.meta[r].score)
                    for r in slot.live if r is not None]
            if live:
                anchor = sum(live) / len(live)
        if anchor is None:
            anchor = self.expected(group, head.score)
            forced = True       # fresh bucket (or aged head): seed = oldest
        exp = [self.expected(group, s.score) for s in q]
        pick = set(heapq.nsmallest(width, range(len(q)),
                                   key=lambda i: (abs(exp[i] - anchor), i)))
        if forced and 0 not in pick:
            pick.remove(max(pick, key=lambda i: (abs(exp[i] - anchor), i)))
            pick.add(0)
        if 0 not in pick:
            head.passed_over += 1
        chosen = [q[i] for i in sorted(pick)]
        kept = [s for i, s in enumerate(q) if i not in pick]
        q.clear()
        q.extend(kept)
        return chosen

    def observe(self, group: _Group, score: float, rounds: int,
                service_s: float = 0.0,
                extra: Tuple[float, ...] = ()) -> None:
        self.history.observe(group.ceilings, score, rounds, extra=extra)


class WindowedAdmission(AdmissionPolicy):
    """Delay-for-fullness admission -- the latency-vs-throughput knob.

    Holds a group's first admission while its staged queue is below
    ``target`` (default: the pipeline's ``max_batch``), for at most
    ``window_s`` seconds of the head request's waiting time, and raises the
    host's pull target meanwhile (``pull_bonus``) so the window fills.
    Backfill of open buckets is never delayed, and an exhausted stream
    makes every group ready at once. A plain iterator that blocks in
    ``__next__`` can overshoot ``window_s``; pair ``windowed`` with
    ``ingest_threads`` when the source can stall."""

    name = "windowed"

    def __init__(self, window_s: float = 0.01, target: int | None = None):
        super().__init__()
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        if target is not None and target < 1:
            raise ValueError(f"target must be >= 1, got {target}")
        self.window_s = window_s
        self.target = target

    def _target(self) -> int:
        assert self.pipeline is not None
        return self.target or self.pipeline.max_batch or 0

    def ready(self, group: _Group, now: float) -> bool:
        assert self.pipeline is not None
        if self.pipeline._exhausted:
            return True
        t = self._target()
        if t and len(group.queue) >= t:
            return True
        return now - group.queue[0].t_enqueue >= self.window_s

    def pull_bonus(self) -> int:
        assert self.pipeline is not None
        t = self._target()
        if not t:
            return 0
        return sum(max(0, t - len(g.queue))
                   for g in self.pipeline._groups.values() if g.queue)

    def wait_hint(self, groups: Iterable[_Group], now: float) -> float:
        rem = [self.window_s - (now - g.queue[0].t_enqueue)
               for g in groups if g.queue]
        rem = [r for r in rem if r > 0]
        return min(rem) if rem else 0.0


def _coupling_stats(arrs: Mapping[str, np.ndarray]) -> Tuple[float, float]:
    """(mean, std) of |log pairwise potential| over real edge entries --
    the coupling-strength features the learned effort model regresses on.
    Numpy on the staging path, bitwise the reference's."""
    lpe = np.asarray(arrs["log_psi_e"])                 # (E, S, S)
    emask = np.asarray(arrs["edge_mask"]).astype(bool)
    if not emask.any():
        return (0.0, 0.0)
    mag = np.abs(np.where(np.isfinite(lpe), lpe, 0.0))[emask]
    return (float(mag.mean()), float(mag.std()))


class SweepClock:
    """Deterministic virtual clock for SLA tests and benches: time is
    *device sweeps*, not wall seconds.

    Inject as ``ServingPipeline(clock=...)``: the pipeline reads ``now``
    via ``clock()`` and, because this class defines ``on_chunk``, advances
    it by ``tau`` virtual seconds per device sweep at every chunk sync, so
    the deadline/eviction story is a pure function of scheduling decisions
    -- identical on any machine. ``advance`` moves time by hand."""

    def __init__(self, tau: float = 1.0):
        if tau <= 0:
            raise ValueError(f"tau must be > 0, got {tau}")
        self.t = 0.0
        self.tau = float(tau)

    def __call__(self) -> float:
        return self.t

    def on_chunk(self, sweeps: int) -> None:
        """Pipeline hook: one chunk of ``sweeps`` device sweeps completed."""
        self.t += float(sweeps) * self.tau

    def advance(self, dt: float) -> None:
        """Move virtual time forward by ``dt`` seconds (manual control)."""
        self.t += float(dt)


class DeadlineAdmission(AdmissionPolicy):
    """SLA-aware admission: earliest-predicted-slack ordering, slot
    packing, and eviction of work that will not make its deadline.

    Requests carry a latency budget from the stream (``(rid, pgm, slo_s)``
    items, or ``default_slo``); *slack* is ``deadline - now - predicted
    service``, with service predicted as the :class:`RoundsHistory` rounds
    estimate times an EWMA seconds-per-round pace per shape family.

    - **Admission order** (``take`` / ``pick_group``): least slack first;
      requests without a deadline order last, and a head skipped ``aging``
      times is force-admitted.
    - **Slot packing** (``pick_many``): fill all free slots in one cycle
      with the most urgent distinct groups.
    - **Eviction** (``should_evict`` / ``cull``): a live request is hopeless
      when its deadline passed, or when its residual decay rate (the faster
      of last-interval and whole-trajectory slope, judged after ``grace``
      syncs) projects convergence to ``eps`` past its deadline; it is
      released as ``status="evicted"`` with its partial beliefs. ``cull``
      gives up on staged requests whose deadline expired while queued.
      ``evict=False`` keeps slack ordering but never gives up on work.

    ``safety`` scales the projected remaining time; ``min_rate`` is the
    decay rate below which a request counts as stalled."""

    name = "deadline"

    def __init__(self, default_slo: float | None = None,
                 safety: float = 1.0, grace: int = 2,
                 min_rate: float = 1e-4, evict: bool = True,
                 pack: bool = True, aging: int = 16,
                 history_capacity: int = 64,
                 history: RoundsHistory | None = None):
        super().__init__()
        if default_slo is not None and default_slo < 0:
            raise ValueError(f"default_slo must be >= 0, got {default_slo}")
        if grace < 1:
            raise ValueError(f"grace must be >= 1, got {grace}")
        if aging < 1:
            raise ValueError(f"aging must be >= 1, got {aging}")
        self.default_slo = default_slo
        self.safety = float(safety)
        self.grace = grace
        self.min_rate = float(min_rate)
        self.evicts = bool(evict)
        self.pack = bool(pack)
        self.aging = aging
        self.history = history if history is not None \
            else RoundsHistory(capacity=history_capacity)
        self._pace: Dict[tuple, float] = {}     # kind -> EWMA sec/round
        self._pace_all: float | None = None
        #: rid -> (rounds, log residual, syncs seen, first-sync rounds,
        #: first-sync log residual) as of the last chunk sync
        self._track: Dict[int, Tuple[int, float, int, int, float]] = {}

    # -- scoring / features ------------------------------------------------

    def score(self, pgm: PGM, arrs: Mapping[str, np.ndarray],
              group: _Group) -> float:
        return _residual_at_admit(arrs)

    def features(self, pgm: PGM, arrs: Mapping[str, np.ndarray],
                 group: _Group) -> Tuple[float, ...]:
        return _coupling_stats(arrs)

    # -- slack -------------------------------------------------------------

    def _slo_of(self, staged: _Staged) -> float | None:
        return staged.slo if staged.slo is not None else self.default_slo

    def _deadline(self, staged: _Staged) -> float | None:
        slo = self._slo_of(staged)
        return None if slo is None else staged.t_enqueue + slo

    def _pace_of(self, ceilings: tuple) -> float:
        pace = self._pace.get(ceilings, self._pace_all)
        return 0.0 if pace is None else pace

    def slack(self, group: _Group, staged: _Staged, now: float) -> float:
        """Predicted slack seconds: time to deadline minus predicted
        service (expected rounds x calibrated pace). Infinite without a
        deadline; cold pace predicts zero service (pure EDF)."""
        deadline = self._deadline(staged)
        if deadline is None:
            return float("inf")
        est = self.history.expect(group.ceilings, staged.score,
                                  default=0.0, extra=staged.extra)
        return deadline - now - est * self._pace_of(group.ceilings)

    def _urgency(self, group: _Group, now: float) -> float:
        return min(self.slack(group, s, now) for s in group.queue)

    # -- admission ---------------------------------------------------------

    def pick_group(self, groups: Iterable[_Group], now: float):
        ready = [g for g in groups if g.queue and self.ready(g, now)]
        return min(ready, key=lambda g: (self._urgency(g, now),
                                         g.queue[0].t_enqueue, g.ceilings),
                   default=None)

    def pick_many(self, groups: Iterable[_Group], now: float,
                  free: int) -> List[_Group]:
        if not self.pack:
            return super().pick_many(groups, now, free)
        ready = [g for g in groups if g.queue and self.ready(g, now)]
        ready.sort(key=lambda g: (self._urgency(g, now),
                                  g.queue[0].t_enqueue, g.ceilings))
        return ready[:free]

    def take(self, group: _Group, width: int,
             slot: "_Slot | None" = None) -> List[_Staged]:
        q = group.queue
        width = min(width, len(q))
        if width == 0:
            return []
        now = self.pipeline.clock() if self.pipeline is not None else 0.0
        order = sorted(range(len(q)),
                       key=lambda i: (self.slack(group, q[i], now),
                                      q[i].t_enqueue, q[i].rid))
        pick = set(order[:width])
        head = q[0]
        if 0 not in pick:
            if head.passed_over >= self.aging:      # aged: force-admit
                pick.remove(order[width - 1])
                pick.add(0)
            else:
                head.passed_over += 1
        chosen = [q[i] for i in sorted(pick)]
        kept = [s for i, s in enumerate(q) if i not in pick]
        q.clear()
        q.extend(kept)
        return chosen

    def cull(self, group: _Group, now: float) -> List[_Staged]:
        if not self.evicts:
            return []
        expired = [s for s in group.queue
                   if (d := self._deadline(s)) is not None and now >= d]
        if expired:
            gone = set(id(s) for s in expired)
            kept = [s for s in group.queue if id(s) not in gone]
            group.queue.clear()
            group.queue.extend(kept)
        return expired

    # -- eviction ----------------------------------------------------------

    def should_evict(self, slot: _Slot, rid: int, rounds: int,
                     residual: float, now: float) -> bool:
        meta = slot.meta[rid]
        slo = meta.slo if meta.slo is not None else self.default_slo
        if slo is None:
            return False
        eps = self.pipeline.engine.config.eps \
            if self.pipeline is not None else 1e-3
        if residual <= eps:
            return False                # converged: releases on this sync
        deadline = meta.t_enqueue + slo
        if now >= deadline:
            return True                 # already missed: stop burning sweeps
        logr = float(np.log(max(residual, 1e-300)))
        prev = self._track.get(rid)
        if prev is None:
            self._track[rid] = (rounds, logr, 1, rounds, logr)
            return False                # need a trajectory before judging
        rounds_prev, logr_prev, syncs, r0, logr0 = prev
        self._track[rid] = (rounds, logr, syncs + 1, r0, logr0)
        if syncs + 1 < self.grace:
            return False
        dr = rounds - rounds_prev
        if dr <= 0:
            return False
        # A transient plateau in the last interval must not doom a request
        # whose whole-trajectory slope is healthy: project with the more
        # optimistic of the two rates.
        rate = (logr_prev - logr) / dr  # log-residual decay per round
        if rounds > r0:
            rate = max(rate, (logr0 - logr) / (rounds - r0))
        if rate <= self.min_rate:       # stalled / diverging: never makes it
            return True
        est_rounds = (logr - float(np.log(eps))) / rate
        eta = now + self.safety * est_rounds * self._pace_of(
            slot.group.ceilings)
        return eta > deadline

    # -- feedback ----------------------------------------------------------

    def observe(self, group: _Group, score: float, rounds: int,
                service_s: float = 0.0,
                extra: Tuple[float, ...] = ()) -> None:
        self.history.observe(group.ceilings, score, rounds, extra=extra)
        if rounds > 0 and service_s > 0:
            pace = service_s / rounds
            old = self._pace.get(group.ceilings)
            self._pace[group.ceilings] = pace if old is None \
                else 0.5 * old + 0.5 * pace
            self._pace_all = pace if self._pace_all is None \
                else 0.5 * self._pace_all + 0.5 * pace

    def forget(self, rid: int) -> None:
        self._track.pop(rid, None)


#: name -> AdmissionPolicy class; names are the canonical serialized form
#: (``BPConfig(admission=...)`` / ``serve_async(admission=...)``).
ADMISSION_POLICIES: Registry[type] = Registry("admission policy", {
    "fifo": FIFOAdmission,
    "residual": ResidualAdmission,
    "windowed": WindowedAdmission,
    "deadline": DeadlineAdmission,
})


def register_admission_policy(name: str, *, overwrite: bool = False):
    """Class decorator registering an :class:`AdmissionPolicy` subclass
    under ``name`` (lowercased), making it addressable by string spec. The
    class must be constructible from keyword arguments. Duplicate names
    raise ``ValueError`` unless ``overwrite=True``."""
    return ADMISSION_POLICIES.register(name, overwrite=overwrite)


def list_admission_policies() -> List[str]:
    """Sorted registered admission-policy names (valid
    ``BPConfig.admission`` / ``serve_async(admission=...)`` specs)."""
    return ADMISSION_POLICIES.names()


def get_admission_policy(spec, **kwargs) -> AdmissionPolicy:
    """Resolve an admission-policy spec: a registry name (+ constructor
    kwargs) or an already-built :class:`AdmissionPolicy` instance (kwargs
    must then be empty)."""
    if isinstance(spec, str):
        return ADMISSION_POLICIES.lookup(spec)(**kwargs)
    if kwargs:
        raise ValueError("admission kwargs only apply to string specs, got "
                         f"instance {type(spec).__name__} plus {kwargs}")
    return spec


# ----------------------------------------------------- threaded ingestion --

_FEEDER_DONE = object()
_FEEDER_EXHAUSTED = object()


def _entry_event(item):
    """An event recorded on the calling thread's current stream when the
    request ``item`` (a ``PGM`` or a ``(rid, PGM[, slo])`` tuple) carries a
    graph on a GPU, else ``None``: staging waits on it before reading the
    graph, so the producer's kernels are ordered before that read."""
    pgm = item[1] if isinstance(item, tuple) and len(item) > 1 else item
    if not isinstance(pgm, PGM) or pgm.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(pgm.device))
    return event


class _IngestFeeder:
    """Feeder threads pulling the request iterator into a bounded queue.

    The stream's ``__next__`` runs on daemon feeder threads (serialized by
    a lock, so any plain iterator is safe); pulled items enter a
    ``queue.Queue(maxsize)`` whose bound is the host-memory guard -- a full
    queue blocks the *feeder*, never the serving loop. Each item is stamped
    under the lock with its arrival index (the auto-rid), its pull time
    (``t_enqueue``) and its entry event (``_entry_event``). Iterator
    exceptions are re-raised on the serving thread once the queue drains.
    Feeders only pull and record the entry event: padding, scoring and
    every other torch call stay on the serving thread. ``close()`` stops
    the workers; puts are bounded waits re-checking the stop flag, so a
    worker blocked on a full queue exits promptly."""

    def __init__(self, it: Iterator, threads: int, maxsize: int,
                 clock=time.perf_counter):
        self._it = it
        self._clock = clock
        self._lock = threading.Lock()
        self._q: _queue.Queue = _queue.Queue(maxsize=max(1, maxsize))
        self._n = 0
        self._live = threads
        self._error: BaseException | None = None
        self._stop = False
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(threads)]
        for t in self._threads:
            t.start()

    def _put(self, x) -> bool:
        """Bounded-wait put that aborts once ``close()`` ran."""
        while not self._stop:
            try:
                self._q.put(x, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self) -> None:
        while True:
            with self._lock:
                if self._error is not None or self._stop:
                    break
                try:
                    item = next(self._it)
                except StopIteration:
                    break
                except BaseException as e:     # surface on serving thread
                    self._error = e
                    break
                rid, self._n = self._n, self._n + 1
                t = self._clock()
                ready = _entry_event(item)
            if not self._put((rid, item, t, ready)):  # blocks when full
                return
        self._put(_FEEDER_DONE)

    def close(self, *, join_timeout: float = 2.0) -> None:
        """Stop the feeder: workers quit pulling at their next check, the
        queue is drained so a worker blocked in ``put`` unblocks, and the
        threads are joined. A worker blocked inside the source's
        ``__next__`` cannot be interrupted; the bounded join leaves such a
        (daemon) thread behind rather than hanging shutdown."""
        self._stop = True
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break
        deadline = time.perf_counter() + max(0.0, join_timeout)
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))

    def get(self, block: bool, timeout: float | None = None):
        """Next ``(auto_rid, item, t_pull, entry_event)``; ``None`` when
        nothing is available right now (non-blocking miss, or ``timeout``
        seconds of a blocking wait), or the exhausted sentinel once every
        feeder thread has finished."""
        while True:
            try:
                got = self._q.get(block=block,
                                  timeout=timeout if block else None)
            except _queue.Empty:
                return None
            if got is _FEEDER_DONE:
                self._live -= 1
                if self._live == 0:
                    if self._error is not None:
                        raise self._error
                    return _FEEDER_EXHAUSTED
                continue
            return got


def _parse(item, rid_auto: int):
    """``(rid, pgm, slo, explicit)`` of a stream item: a ``PGM`` (rid =
    ``rid_auto``, its arrival index), a ``(rid, PGM)`` pair or a ``(rid,
    PGM, slo_s)`` triple (``rid=None`` keeps ``rid_auto``); ``explicit``
    says the stream named the rid."""
    if not isinstance(item, tuple):
        return rid_auto, item, None, False
    if len(item) == 3:
        rid, pgm, slo = item
        slo = None if slo is None else float(slo)
    else:
        (rid, pgm), slo = item, None
    if rid is None:
        return rid_auto, pgm, slo, False
    return int(rid), pgm, slo, True


class _Provider:
    """A follower's source (see :class:`ServingPipeline`): the requests its
    leader names, by rid, from the follower's own copy of the stream -- a
    plain iterator, pulled here, or an ``_IngestFeeder``, waited on for at
    most ``timeout`` seconds. Items pulled ahead of their turn wait in a
    buffer. A stream that ends, or a feeder that stays silent, before the
    named rid shows up means the ranks were not given the same stream: it
    raises."""

    def __init__(self, it, timeout: float):
        self._it = it
        self._timeout = timeout
        self._buf: Dict[int, Tuple[PGM, Any]] = {}
        self._n = 0

    def take(self, rid: int):
        """``(pgm, entry event)`` of request ``rid``."""
        while rid not in self._buf:
            if isinstance(self._it, _IngestFeeder):
                got = self._it.get(True, timeout=self._timeout)
                if got is None or got is _FEEDER_EXHAUSTED:
                    raise RuntimeError(
                        f"request {rid}, which the leader staged, is not in "
                        "this rank's stream (ended, or silent for "
                        f"{self._timeout:g} s): every rank of a mesh must "
                        "pass the same stream")
                rid_auto, item, _, ready = got
            else:
                try:
                    item = next(self._it)
                except StopIteration:
                    raise RuntimeError(
                        f"request {rid}, which the leader staged, is not in "
                        "this rank's stream: every rank of a mesh must pass "
                        "the same stream") from None
                rid_auto, ready = self._n, _entry_event(item)
                self._n += 1
            got_rid, pgm, _, _ = _parse(item, rid_auto)
            self._buf[got_rid] = (pgm, ready)
        return self._buf.pop(rid)


# --------------------------------------------------------------- pipeline --

class ServingPipeline:
    """The asynchronous serving pipeline (see module docstring).

    One pipeline instance serves one stream through one ``BPEngine``, on
    the engine's device. ``serve(stream)`` is a generator yielding a
    ``RequestRecord`` per request *in completion order*; :func:`serve_async`
    collects everything.

    Knobs: ``slots`` bounds resident buckets stepped per cycle (1
    reproduces ``BPEngine.serve``'s cadence exactly); ``prefetch`` is the
    staged-request low-water mark the host keeps pulled ahead of admission
    (``None`` = drain the stream up front); ``evacuate``/``compact`` toggle
    the straggler policies; ``admission`` picks the admission policy -- a
    registry spec string (constructed with ``admission_kwargs``) or an
    :class:`AdmissionPolicy`; ``None`` defers to the engine's
    ``BPConfig.admission``. ``ingest_threads=N`` moves the stream pull onto
    ``N`` feeder threads behind a bounded queue (``ingest_queue`` items,
    default max(prefetch, 2N)). ``record_events=False`` drops the
    per-request logs (counters stay); ``plan`` maps a ``bucket_key`` to
    explicit group ceilings (the materialized-stream path) -- without it
    each request pads to its own ``bucket_shape`` ceilings.

    The stream may yield ``PGM``s (rid = arrival order; on any device --
    staging moves them to the engine's), ``(rid, PGM)`` pairs, or ``(rid,
    PGM, slo_s)`` triples (``rid=None`` keeps arrival-order rids). ``clock``
    replaces the time source (default ``time.perf_counter``); a clock with
    ``on_chunk(sweeps)`` (:class:`SweepClock`) is advanced at every chunk
    sync. ``rng`` is a base seed (an int, or a ``torch.Generator`` whose
    ``initial_seed()`` is taken): request ``rid`` draws from
    ``slot_generator(base, rid)``, so results are independent of every
    pipeline knob; only the padded-shape policy (plan vs online) can alter
    stochastic-scheduler trajectories, the caveat shared with ``run_many``.

    Lifecycle: a pipeline is a context manager; ``close()`` stops and joins
    any live ingest feeder threads and refuses further ``serve`` calls.

    On a mesh (an engine of the sharded backend, ``repro_torch.dist``) every
    rank of the mesh runs this pipeline on the same stream, and every
    decision that depends on time or thread timing is taken once, by the
    mesh's rank 0 (``role == "leader"``): the clock readings that culling,
    ``pick_many`` and ``should_evict`` read, which requests a non-blocking
    pull took from the feeder, the holds and sleeps while nothing is
    resident -- in effect, which rids are culled, admitted into which
    slots, backfilled, evicted and compacted. Its decisions, with the
    timeline stamps, go to the mesh's other ranks (``role ==
    "follower"``) by ``dist.comm.publish`` on the mesh's gloo group at
    most twice a cycle: before the chunks are stepped (pulls, culls,
    admissions) and after the slots' syncs (releases, evictions,
    backfills, compactions). A follower applies them and never consults
    its clock, its policy or the order of its feeder: it takes from its own
    copy of the stream exactly the requests the leader names, by rid,
    waiting on its feeder for them. So every rank of a mesh issues the same
    collectives in the same order and yields the same records. On a mesh a
    cycle decides first and then runs the device work its decisions imply
    -- results, slot loads, compactions, all collectives -- in decision
    order (``_apply``), so its stamps are decision times: ``t_done`` before
    the result is read, a backfill's ``t_admit`` before its load. On one
    device that work runs as each decision is taken, and ``t_done`` follows
    the read of the result.
    """

    def __init__(self, engine: BPEngine, rng, *,
                 growth: float = 2.0, max_batch: int | None = None,
                 chunk_rounds: int | None = None, evacuate: bool = True,
                 compact: bool = True, slots: int = 2,
                 prefetch: int | None = 8,
                 record_events: bool = True,
                 plan: Dict[tuple, tuple] | None = None,
                 admission: "str | AdmissionPolicy | None" = None,
                 admission_kwargs: Mapping | None = None,
                 ingest_threads: int = 0,
                 ingest_queue: int | None = None,
                 clock=None):
        if engine.is_serial:
            raise NotImplementedError(
                "serving needs a frontier scheduler (srbp is host-serial)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_batch is not None and max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if ingest_threads < 0:
            raise ValueError(
                f"ingest_threads must be >= 0, got {ingest_threads}")
        cfg = engine.config
        self.engine = engine
        self.base = rng.initial_seed() if isinstance(rng, torch.Generator) \
            else int(rng)
        self.device = engine.device
        self.growth = growth
        self.max_batch = max_batch
        self.chunk = (chunk_rounds or cfg.chunk_rounds
                      or max(1, cfg.max_rounds // 16))
        self.evacuate = evacuate
        self.compact = compact
        self.slots = slots
        self.prefetch = prefetch
        self.record_events = record_events
        self.plan = plan
        self.ingest_threads = ingest_threads
        self.ingest_queue = ingest_queue
        self.clock = clock if clock is not None else time.perf_counter
        self._clock_on_chunk = getattr(self.clock, "on_chunk", None)
        if admission is None:
            admission = cfg.admission
            if admission_kwargs is None:
                admission_kwargs = dict(cfg.admission_kwargs)
        self.policy = get_admission_policy(
            admission, **dict(admission_kwargs or {})).bind(self)
        #: ``"leader"`` or ``"follower"`` on a mesh of several ranks, else
        #: ``None`` (see the class docstring)
        self.role = None
        self._decisions = None          # the mesh, for its gloo group
        mesh = getattr(engine.update_fn, "mesh", None)
        if mesh is not None:
            from repro_torch import dist as D
            axis = getattr(engine.update_fn, "axis", D.BP_AXIS)
            n, rank, _ = D.mesh_axis(mesh, axis)
            if n > 1:
                if not isinstance(mesh, D.BPMesh):
                    raise ValueError(
                        "serving on a mesh needs the gloo group beside it "
                        "that repro_torch.dist.make_bp_mesh makes")
                self.role = "leader" if rank == 0 else "follower"
                self._decisions = mesh
        #: how long a follower waits on its stream for a named request
        self._wait_s = (D.comm.world_timeout().total_seconds()
                        if mesh is not None else 0.0)
        self._log: List[tuple] | None = [] if self.role == "leader" else None
        #: rid -> an opaque picklable note a source attaches to a request
        #: before yielding it; a leader passes it on to its followers
        self.tags: Dict[int, Any] = {}
        #: called with no argument after each stepped cycle
        self.on_cycle = None
        self._todo: List[tuple] = []    # the cycle's device work, in order
        self.stats = AsyncServeStats(policy=self.policy.name)
        self._groups: Dict[tuple, _Group] = {}
        self._exhausted = False
        self._arrival = 0
        # Duplicate-rid detection only applies once the stream supplies
        # explicit rids; auto-assigned rids are unique by construction.
        self._explicit_rids = False
        self._seen_rids: set[int] = set()
        self._feeder: _IngestFeeder | None = None
        self._closed = False
        # A sharded engine copies each rank's slice to the card itself
        # (engine.init): its staged requests stay on the host.
        self._host_staging = mesh is not None
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda"
                             and not self._host_staging else None)

    # -- staging (host padding + copy to the device) -----------------------

    def _group_for(self, pgm: PGM) -> _Group:
        if self.plan is not None:
            key = bucket_key(pgm, self.growth)
            ceilings = self.plan[key]
        else:
            key = ceilings = bucket_shape(pgm, self.growth)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(ceilings, key)
        return group

    def _to_device(self, host: Dict[str, np.ndarray]):
        """``(tensors on the engine's device, copy)``: on a GPU, from
        pinned host memory on the copy stream, ``copy = (event, pinned
        tensors)``; elsewhere a plain copy and ``copy = None``. A sharded
        engine's stay on the host."""
        if self._host_staging:
            return {k: torch.from_numpy(v) for k, v in host.items()}, None
        if self._copy_stream is None:
            return {k: torch.tensor(v, device=self.device)
                    for k, v in host.items()}, None
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in host.items()}
        with torch.cuda.stream(self._copy_stream):
            dev = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, (event, pinned)

    def _ready(self, staged: _Staged) -> PGM:
        """The staged element, safe to use on the compute stream: the
        stream waits on the element's copy, and its tensors are marked as
        used there (``record_stream``) so their memory outlives the reads
        queued on it. The pinned host copies are released."""
        if staged.copy is not None:
            event, _ = staged.copy
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for k in _TENSOR_FIELDS:
                getattr(staged.elem, k).record_stream(stream)
            staged.copy = None
        return staged.elem

    def _stage(self, rid: int, pgm: PGM, t_enqueue: float,
               slo: float | None = None, ready=None) -> None:
        if self._explicit_rids:         # rid = generator index: must be 1:1
            if rid in self._seen_rids:
                raise ValueError(f"duplicate request id {rid} in stream")
            self._seen_rids.add(rid)
        if ready is not None:           # the graph's producer ran elsewhere
            torch.cuda.current_stream(pgm.device).wait_event(ready)
        group = self._group_for(pgm)
        e, v, s, re_, rv = group.ceilings
        arrs = pad_pgm_arrays(pgm, n_edges=e, n_vertices=v, n_states=s)
        score = self.policy.score(pgm, arrs, group)
        extra = tuple(self.policy.features(pgm, arrs, group))
        # The prefetch: the copy starts now, ahead of admission.
        tensors, copy = self._to_device(host_operands(arrs))
        elem = PGM(**tensors, n_real_vertices=rv, n_real_edges=re_,
                   edge_count=pgm.edge_count, vertex_count=pgm.vertex_count)
        group.queue.append(_Staged(
            rid, elem, slot_generator(self.base, rid, self.device),
            t_enqueue, score=score, slo=slo, extra=extra, copy=copy))
        self.stats.staged += 1

    def _staged_count(self) -> int:
        return sum(len(g.queue) for g in self._groups.values())

    def _pump(self, it, target: float, block: bool = False) -> None:
        """Pull requests until ``target`` are staged (or the stream ends).
        With a feeder source, ``block=False`` only drains what the feeder
        already pulled; a plain iterator blocks in ``next`` either way."""
        while not self._exhausted and self._staged_count() < target:
            if isinstance(it, _IngestFeeder):
                got = it.get(block)
                if got is None:
                    return
                if got is _FEEDER_EXHAUSTED:
                    self._exhausted = True
                    return
                rid_auto, item, t, ready = got
            else:
                try:
                    item = next(it)
                except StopIteration:
                    self._exhausted = True
                    return
                t = self.clock()
                rid_auto = self._arrival
                ready = _entry_event(item)
            rid, pgm, slo, explicit = _parse(item, rid_auto)
            if explicit:
                self._explicit_rids = True
            self._arrival += 1
            self._stage(rid, pgm, t, slo=slo, ready=ready)
            self._note("pull", rid, t, slo, self.tags.get(rid))

    # -- decisions: taken by the leader, applied by every rank -------------

    def _note(self, *decision) -> None:
        """Log one decision for the followers (a leader only)."""
        if self._log is not None:
            self._log.append(decision)

    def _publish(self, final: bool = False) -> None:
        """A leader sends its decisions since the last call to its group
        (``final`` appends the end of the stream); a no-op elsewhere."""
        if self._log is None:
            return
        from repro_torch.dist import comm
        log, self._log = self._log, []
        if final:
            log.append(("finish",))
        comm.publish(log, self._decisions.host_group)

    def _receive(self) -> List[tuple]:
        """A follower's next batch of its leader's decisions."""
        from repro_torch.dist import comm
        return comm.publish(None, self._decisions.host_group)

    def _claim(self, group: _Group, rid: int) -> _Staged:
        """Remove staged request ``rid`` from ``group``'s queue: a follower
        applying its leader's choice."""
        for k, staged in enumerate(group.queue):
            if staged.rid == rid:
                del group.queue[k]
                return staged
        raise RuntimeError(f"request {rid} is not staged on this rank: its "
                           "leader's decisions diverged from its state")

    # -- slot lifecycle ----------------------------------------------------

    def _admit(self, group: _Group) -> _Slot:
        """Open a resident bucket from the group's queue: width =
        min(max_batch, pending), composition chosen by the admission
        policy, stacked on the device from staged elements."""
        width = min(self.max_batch or len(group.queue), len(group.queue))
        return self._open(group, self.policy.take(group, width))

    def _open(self, group: _Group, take: List[_Staged],
              t: float | None = None) -> _Slot:
        """The resident bucket of the staged requests ``take``; ``t`` is
        the admission stamp (the clock's, read after ``init``, if None)."""
        batch = BatchedPGM.from_pgms([self._ready(s) for s in take])
        state = self.engine.init(batch, [s.key for s in take])
        t = self.clock() if t is None else t
        self._note("admit", group.key, [s.rid for s in take], t)
        self.stats.buckets_opened += 1
        if self.record_events:
            self.stats.admission_widths.append(len(take))
        return _Slot(group=group, state=state,
                     live=[s.rid for s in take],
                     rounds_host=np.zeros(len(take), np.int64),
                     r_before=np.zeros(len(take), np.int64),
                     meta={s.rid: _AdmitMeta(s.t_enqueue, t, s.score,
                                             slo=s.slo, extra=s.extra)
                           for s in take})

    def _release(self, i: int, slot: _Slot, j: int, rounds: int,
                 t: float | None = None, status: str = "completed") -> None:
        """Release batch slot ``j`` of resident slot ``i``: its record, with
        ``status``, at ``t`` (the clock's, read after the result on one
        device; on a mesh ``_apply`` reads it after the decisions). An
        evicted request (``status="evicted"``) releases its
        partial beliefs at the last chunk sync, and its sweeps count under
        ``evicted_sweeps``; the policy is not ``observe``d (an evicted
        round count is not a convergence effort sample), only
        ``forget``-ed."""
        rid = slot.live[j]
        assert rid is not None
        slot.live[j] = None
        self.stats.evacuated += 1
        evicted = status == "evicted"
        if evicted:
            self.stats.evictions += 1
            self.stats.evicted_sweeps += rounds
        if self.record_events:      # O(requests) log; off for infinite streams
            (self.stats.eviction_log if evicted else
             self.stats.evacuation_log).append((self.stats.chunks, rid))
        meta = slot.meta.pop(rid)
        result = (None if self.role is not None
                  else self.engine._slice_result(slot.state, j))
        t_done = self.clock() if t is None else t
        if not evicted:
            self.policy.observe(slot.group, meta.score, rounds,
                                service_s=max(t_done - meta.t_admit, 0.0),
                                extra=meta.extra)
        self.policy.forget(rid)
        self._note("release", i, j, rounds, t_done, status)
        self._todo.append(("result", slot, j, RequestRecord(
            rid=rid, result=result, t_enqueue=meta.t_enqueue,
            t_admit=meta.t_admit, t_done=t_done, slo_s=meta.slo,
            status=status)))

    def _evict_staged(self, group: _Group, staged: _Staged,
                      t: float | None = None) -> RequestRecord:
        """Give up on a request whose deadline expired while queued: zero
        service, prior beliefs (normalized unary potentials -- uniform
        initial messages cancel in per-vertex normalization) and round-0
        messages, computed in float64 on the host and returned as float32
        tensors on the engine's device, ``status="evicted"``."""
        elem = self._ready(staged)
        lpv = elem.log_psi_v.cpu().numpy()                      # (V, S)
        smask = elem.state_mask.cpu().numpy()
        x = np.where(smask, lpv, NEG_INF)
        m = np.maximum(x.max(axis=1, keepdims=True), NEG_INF)
        z = m + np.log(np.maximum(
            np.where(smask, np.exp(x - m), 0.0).sum(axis=1, keepdims=True),
            1e-38))
        dev = self.device
        beliefs = torch.tensor(np.where(smask, x - z, NEG_INF),
                               dtype=torch.float32, device=dev)
        dst = elem.edge_dst.cpu().numpy()
        n_states = elem.n_states.cpu().numpy().astype(np.float64)
        logm = torch.tensor(                # the round-0 uniform messages
            np.where(smask[dst], -np.log(n_states[dst])[:, None], NEG_INF),
            dtype=torch.float32, device=dev)
        cfg = self.engine.config
        result = BPResult(
            beliefs=beliefs, logm=logm,
            rounds=torch.zeros((), dtype=torch.int32, device=dev),
            updates=torch.zeros((), dtype=torch.int64, device=dev),
            converged=torch.zeros((), dtype=torch.bool, device=dev),
            max_residual=torch.tensor(staged.score, dtype=torch.float32,
                                      device=dev),
            unconverged_history=torch.full(
                (cfg.max_rounds if cfg.history else 1,), -1,
                dtype=torch.int32, device=dev),
            sched_state=None)
        self.stats.evictions += 1
        if self.record_events:
            self.stats.eviction_log.append((self.stats.chunks, staged.rid))
        t = self.clock() if t is None else t
        self._note("cull", group.key, staged.rid, t)
        self.policy.forget(staged.rid)
        return RequestRecord(rid=staged.rid, result=result,
                             t_enqueue=staged.t_enqueue,
                             t_admit=t, t_done=t,
                             slo_s=staged.slo, status="evicted")

    def _cull(self) -> Iterator[RequestRecord]:
        """Ask the policy for staged requests to give up on (expired
        deadlines) and release them with prior beliefs."""
        now = self.clock()
        for group in self._groups.values():
            for staged in self.policy.cull(group, now):
                yield self._evict_staged(group, staged)

    def _backfill(self, i: int, slot: _Slot, j: int, rid: int | None = None,
                  t: float | None = None) -> None:
        """Load a staged request into free batch slot ``j`` of resident
        slot ``i``: the policy's pick (request ``rid`` on a follower),
        admitted at ``t`` (the clock's if None); loaded now on one device,
        by ``_apply`` on a mesh."""
        staged = (self.policy.take(slot.group, 1, slot=slot)[0]
                  if rid is None else self._claim(slot.group, rid))
        if self.role is None:
            self._load(slot, j, staged)
        else:
            self._todo.append(("load", slot, j, staged))
        slot.live[j] = staged.rid
        slot.rounds_host[j] = 0
        t = self.clock() if t is None else t
        slot.meta[staged.rid] = _AdmitMeta(staged.t_enqueue, t,
                                           staged.score, slo=staged.slo,
                                           extra=staged.extra)
        self.stats.backfilled += 1
        self._note("backfill", i, j, staged.rid, t)

    def _maybe_compact(self, i: int, slot: _Slot) -> None:
        """Re-bucket survivors into a narrower batch once no backfill can
        ever arrive (queue drained, stream exhausted). Pow2 target widths;
        surplus slots are filled with already-dead entries, which the gated
        chunk body keeps inert."""
        if not (self.compact and self.evacuate and self._exhausted
                and not slot.group.queue):
            return
        keep = [j for j, rid in enumerate(slot.live) if rid is not None]
        if not keep:
            return
        new_w = _pow2_ceil(len(keep))
        if new_w >= slot.width:
            return
        dead = [j for j, rid in enumerate(slot.live) if rid is None]
        self._compact(i, slot, sorted(keep + dead[:new_w - len(keep)]))

    def _compact(self, i: int, slot: _Slot, chosen: List[int]) -> None:
        """Narrow resident slot ``i`` to batch slots ``chosen`` (now on one
        device, by ``_apply`` on a mesh)."""
        self.stats.compactions += 1
        if self.record_events:
            self.stats.compaction_log.append(
                (self.stats.chunks, slot.width, len(chosen)))
        slot.live = [slot.live[j] for j in chosen]
        slot.rounds_host = slot.rounds_host[chosen]
        slot.r_before = slot.r_before[chosen]
        self._note("compact", i, chosen)
        if self.role is None:
            slot.state = _narrow_state(slot.state, chosen)
        else:
            self._todo.append(("narrow", slot, chosen, None))

    def _sync(self, state: BPState):
        """One device-to-host copy per slot sync: per-graph rounds, done
        flags and max residuals, and the chunk's loop iterations (float64
        holds every int32 and float32 exactly)."""
        w = state.rounds.shape[0]
        host = torch.cat([state.rounds.double(), state.done.double(),
                          state.max_residual.double(),
                          state.chunk_iters.double().reshape(1)]).cpu()
        host = host.numpy()
        return (host[:w].astype(np.int64), host[w:2 * w] > 0,
                host[2 * w:3 * w], int(host[-1]))

    def _account(self, slot: _Slot):
        """Sync one stepped slot and account its sweeps; ``(rounds, done,
        residuals)`` per batch slot. On a mesh these are the whole vectors
        on every rank, so every rank accounts alike."""
        r_after, done, resid, chunk_iters = self._sync(slot.state)
        inner = self.engine.scheduler.inner_sweeps
        self.stats.chunks += 1
        chunk_sweeps = chunk_iters * inner * slot.width
        self.stats.device_sweeps += chunk_sweeps
        self.stats.useful_sweeps += int(sum(
            int(r_after[j] - slot.r_before[j])
            for j in range(slot.width) if slot.live[j] is not None))
        slot.rounds_host = r_after.copy()
        if self._clock_on_chunk is not None:   # virtual clocks tick in sweeps
            self._clock_on_chunk(chunk_sweeps)
        return r_after, done, resid

    def _service(self, i: int, slot: _Slot) -> Iterator[RequestRecord]:
        """Sync resident slot ``i`` and decide its straggler policies:
        account sweeps, release finished graphs, backfill freed slots from
        the group queue, evict, then consider compaction. One device yields
        each record as it is released; on a mesh the device work these
        imply is queued for ``_apply``."""
        r_after, done, resid = self._account(slot)
        max_rounds = self.engine.config.max_rounds
        if not self.evacuate:
            # Run-to-completion baseline: release everything only when the
            # whole bucket is finished; never backfill, never compact.
            if all(bool(done[j]) or r_after[j] >= max_rounds
                   for j in range(slot.width)):
                for j in range(slot.width):
                    self._release(i, slot, j, int(r_after[j]))
                    yield from self._released()
            return
        for j in range(slot.width):
            if slot.live[j] is None:
                continue
            if bool(done[j]) or r_after[j] >= max_rounds:
                self._release(i, slot, j, int(r_after[j]))
                yield from self._released()
                if slot.group.queue:
                    self._backfill(i, slot, j)
        if self.policy.evicts:
            # Mid-flight eviction: per-graph residuals at this sync are the
            # converging-too-slowly signal; hopeless requests release now
            # (partial beliefs) instead of burning sweeps to max_rounds. As
            # in the reference, a slot backfilled above is judged on the
            # rounds and residual its previous occupant had at this sync.
            now = self.clock()
            for j in range(slot.width):
                rid = slot.live[j]
                if rid is None:
                    continue
                if self.policy.should_evict(slot, rid, int(r_after[j]),
                                            float(resid[j]), now):
                    self._release(i, slot, j, int(r_after[j]),
                                  status="evicted")
                    yield from self._released()
                    if slot.group.queue:
                        self._backfill(i, slot, j)
        # Slots that went dead while the queue was momentarily empty are
        # revived by later arrivals.
        for j in range(slot.width):
            if slot.live[j] is None and slot.group.queue:
                self._backfill(i, slot, j)
        self._maybe_compact(i, slot)

    def _load(self, slot: _Slot, j: int, staged: _Staged) -> None:
        """Load a backfilled request into batch slot ``j``'s state."""
        slot.state = self.engine.load_slot(slot.state, j,
                                           self._ready(staged), staged.key)

    def _released(self) -> Iterator[RequestRecord]:
        """One device: the record just released, its result already read.
        On a mesh nothing: ``_apply`` yields it after the decisions."""
        if self.role is None:
            yield from self._apply()

    def _apply(self) -> Iterator[RequestRecord]:
        """Yield the released records in decision order. On a mesh, first
        run the device work the decisions imply, in their order -- each
        released request's result, each backfill's load, each compaction:
        collectives that every rank issues in this order."""
        todo, self._todo = self._todo, []
        for op, slot, j, x in todo:
            if op == "result":
                if x.result is None:
                    x.result = self.engine._slice_result(slot.state, j)
                yield x
            elif op == "load":
                self._load(slot, j, x)
            else:
                slot.state = _narrow_state(slot.state, j)

    # -- the drive loop ----------------------------------------------------

    def _await_work(self, it) -> bool:
        """Nothing is resident: wait until something becomes admissible.
        Returns False when serving is finished (stream exhausted, nothing
        staged). Blocks on the source only when nothing at all is staged;
        when work is staged but held (an open admission window), pulls
        toward the policy's fill target and sleeps out a slice of the
        window instead."""
        if not self._staged_count():
            if self._exhausted:
                return False
            self._pump(it, 1, block=True)
            return bool(self._staged_count()) or not self._exhausted
        before = self._staged_count()
        target = before + self.policy.pull_bonus()
        if target > before:
            self._pump(it, target)
        hint = self.policy.wait_hint(self._groups.values(), self.clock())
        if self._staged_count() == before and hint > 0:
            time.sleep(min(hint, 0.05))
        return True

    def serve(self, stream: Iterable) -> Iterator[RequestRecord]:
        """Drive ``stream`` through the pipeline, yielding one
        ``RequestRecord`` per request in completion order.

        Each cycle: (1) admit staged groups into free slots, (2) step a
        chunk on every slot, (3) pull and stage new arrivals (from the
        feeder queue when ``ingest_threads`` is set, never blocking on the
        source), (4) sync and service each slot, then release the results.
        Terminates when the stream is exhausted and every admitted graph
        has been released. A follower applies its leader's decisions
        instead (see the class docstring)."""
        if self._closed:
            raise ValueError("ServingPipeline is closed")
        it = iter(stream)
        if self.ingest_threads:
            bound = self.ingest_queue or max(self.prefetch or 8,
                                             2 * self.ingest_threads)
            it = self._feeder = _IngestFeeder(it, self.ingest_threads, bound,
                                              clock=self.clock)
        try:
            if self.role == "follower":
                yield from self._follow(_Provider(it, self._wait_s))
            else:
                yield from self._drive(it)
        finally:
            # An abandoned generator or a staging error must not leak
            # feeder threads blocked on a full queue.
            if isinstance(it, _IngestFeeder):
                it.close()
            self._feeder = None

    def close(self) -> None:
        """Shut the pipeline down: stop (and join) any live ingest feeder
        threads and refuse further ``serve`` calls. Idempotent.
        Staged-but-unserved requests are dropped."""
        self._closed = True
        feeder, self._feeder = self._feeder, None
        if feeder is not None:
            feeder.close()

    def __enter__(self) -> "ServingPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Context-manager exit: ``close()`` -- feeder threads joined."""
        self.close()

    def _step(self, resident: List[_Slot]) -> None:
        for slot in resident:
            slot.r_before = slot.rounds_host.copy()
            slot.state = self.engine.step(slot.state, chunk_rounds=self.chunk)

    def _drive(self, it) -> Iterator[RequestRecord]:
        """The cycle loop behind ``serve`` (source already feeder-wrapped),
        which a leader also publishes its decisions from."""
        resident: List[_Slot] = []
        if self.prefetch is None:
            self._pump(it, float("inf"), block=True)
        while True:
            yield from self._cull()     # expired-while-staged give-ups
            while len(resident) < self.slots:
                free = self.slots - len(resident)
                picks = self.policy.pick_many(self._groups.values(),
                                              self.clock(), free)
                if not picks:
                    self._pump(it, max(1, self.prefetch or 1)
                               + self.policy.pull_bonus())
                    picks = self.policy.pick_many(self._groups.values(),
                                                  self.clock(), free)
                    if not picks:
                        if self._staged_count():   # held by an open window
                            self.stats.admission_holds += 1
                            self._note("hold")
                        break
                for group in picks[:free]:
                    if group.queue:
                        resident.append(self._admit(group))
            if not resident:
                if not self._await_work(it):
                    self._publish(final=True)
                    return
                continue
            self._publish()             # before the step's collectives
            self._step(resident)
            if self.prefetch:
                # Host-side staging after the chunks. Dead slots whose group
                # queue is empty raise the pull target: staged work from
                # *other* groups must not stop us from fetching requests
                # that could revive them. A holding policy adds its fill
                # deficit on top.
                hunger = sum(1 for slot in resident for rid in slot.live
                             if rid is None and not slot.group.queue)
                self._pump(it, self.prefetch + hunger
                           + self.policy.pull_bonus())
            for i, slot in enumerate(resident):
                yield from self._service(i, slot)
            self._publish()             # before the results' collectives
            yield from self._apply()
            resident[:] = [s for s in resident
                           if any(rid is not None for rid in s.live)]
            if self.on_cycle is not None:
                self.on_cycle()

    def _follow(self, provider: _Provider) -> Iterator[RequestRecord]:
        """A follower's cycle loop: the leader's decisions applied as
        ``_drive`` takes them, with the same device work in the same order
        and the leader's stamps, so its records are the leader's."""
        resident: List[_Slot] = []

        def stage(rid, t, slo, tag):
            pgm, ready = provider.take(rid)
            if tag is not None:
                self.tags[rid] = tag
            self._arrival += 1
            self._stage(rid, pgm, t, slo=slo, ready=ready)

        while True:
            for d in self._receive():
                if d[0] == "pull":
                    stage(*d[1:])
                elif d[0] == "cull":
                    group = self._groups[d[1]]
                    yield self._evict_staged(group, self._claim(group, d[2]),
                                             d[3])
                elif d[0] == "admit":
                    group = self._groups[d[1]]
                    resident.append(self._open(
                        group, [self._claim(group, r) for r in d[2]], d[3]))
                elif d[0] == "hold":
                    self.stats.admission_holds += 1
                elif d[0] == "finish":
                    return
                else:
                    raise RuntimeError(f"decision {d!r} before a step")
            if not resident:
                raise RuntimeError("the leader stepped with no bucket "
                                   "resident on this rank")
            self._step(resident)
            synced = 0
            for d in self._receive():
                if d[0] == "pull":
                    stage(*d[1:])
                    continue
                i = d[1]
                while synced <= i:      # the leader's order: sync, decide
                    self._account(resident[synced])
                    synced += 1
                slot = resident[i]
                if d[0] == "release":
                    self._release(i, slot, *d[2:])
                elif d[0] == "backfill":
                    self._backfill(i, slot, *d[2:])
                elif d[0] == "compact":
                    self._compact(i, slot, d[2])
                else:
                    raise RuntimeError(f"decision {d!r} after a step")
            for slot in resident[synced:]:
                self._account(slot)
            yield from self._apply()
            resident[:] = [s for s in resident
                           if any(rid is not None for rid in s.live)]
            if self.on_cycle is not None:
                self.on_cycle()


def _materialized_plan(pgms: Sequence[PGM], growth: float):
    """The plan for a fully materialized stream: group by ``bucket_key``,
    pad every member to its *group's* joint ceilings, and feed requests in
    sorted-key order -- ``BPEngine.serve``'s policy, so trajectories (and
    with ``slots=1`` sweep accounting too) coincide."""
    keyed: Dict[tuple, List[int]] = {}
    for i, p in enumerate(pgms):
        keyed.setdefault(bucket_key(p, growth), []).append(i)
    plan, ordered = {}, []
    for key in sorted(keyed):
        idx = keyed[key]
        plan[key] = group_ceilings([pgms[i] for i in idx])
        ordered.extend((i, pgms[i]) for i in idx)
    return plan, ordered


def serve_async(engine: BPEngine, stream, rng, *,
                growth: float = 2.0, max_batch: int | None = None,
                chunk_rounds: int | None = None, evacuate: bool = True,
                compact: bool = True, slots: int = 2,
                prefetch: int | None = 8,
                record_events: bool = True,
                admission: "str | AdmissionPolicy | None" = None,
                admission_kwargs: Mapping | None = None,
                ingest_threads: int = 0,
                ingest_queue: int | None = None,
                clock=None) -> AsyncServeResult:
    """Serve a request stream through the asynchronous pipeline.

    ``stream`` is either a materialized ``Sequence[PGM]`` -- padded with
    the group-ceiling plan, so per-request results are *bitwise identical*
    to ``BPEngine.serve`` on the same inputs -- or any iterator of PGMs
    (the online path: each request pads to its own ``bucket_shape``
    ceilings the moment it arrives). Iterator items may also be ``(rid,
    PGM)`` pairs or ``(rid, PGM, slo_s)`` deadline triples. ``rng`` is a
    base seed (int or ``torch.Generator``). See :class:`ServingPipeline`
    for the knobs. Collects the generator into an
    :class:`AsyncServeResult` (records in completion order, ``.results``
    in input order)."""
    plan = None
    # Only a sequence of bare PGMs takes the materialized-plan path:
    # (rid, pgm[, slo]) tuple sequences keep their explicit rids and stream
    # online.
    if isinstance(stream, Sequence) and (
            not stream or isinstance(stream[0], PGM)):
        plan, stream = _materialized_plan(list(stream), growth)
    pipe = ServingPipeline(engine, rng, growth=growth, max_batch=max_batch,
                           chunk_rounds=chunk_rounds, evacuate=evacuate,
                           compact=compact, slots=slots, prefetch=prefetch,
                           record_events=record_events, plan=plan,
                           admission=admission,
                           admission_kwargs=admission_kwargs,
                           ingest_threads=ingest_threads,
                           ingest_queue=ingest_queue, clock=clock)
    records = list(pipe.serve(stream))
    return AsyncServeResult(records=records, stats=pipe.stats)
