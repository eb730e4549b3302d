"""Router: one heterogeneous request stream fanned out across N replicas.

The port of ``repro.serve.router``. The :class:`Router` is the serving
tier above ``ServingPipeline``: it pulls requests off a single stream,
stamps each with its arrival rid and deterministic ``bucket_shape`` kind,
places it on a replica through a pluggable
:class:`~repro_torch.serve.routing.RoutingPolicy` (the
``ROUTING_POLICIES`` registry family), and merges every replica's released
records back into one completion-order result stream with replica
attribution and tier-level latency percentiles.

Two properties are load-bearing:

- **Determinism pin.** Per-request results depend only on (rid, padded
  shape): every replica holds the same base seed (request ``rid`` draws
  from ``slot_generator(base, rid)``) and the online path pads each
  request to its own
  ``bucket_shape`` ceilings, identical on every replica. With
  ``routing="round_robin"`` and ``steal=False`` each replica's share is a
  pure function of arrival order, so the router's per-request results are
  *bitwise identical* to running each share through ``serve_async`` solo
  (pinned by test); load-aware routing and stealing move requests between
  replicas without changing any result bit -- only where the sweeps run.
- **Work stealing.** A replica whose pending work drains below its low
  watermark pulls a batch from the tail of the deepest peer's inbox
  (router-arbitrated, one steal at a time). On a skewed stream this
  converts the thief's dead-slot sweeps into useful ones: same-shape
  stolen requests backfill the very slots that would otherwise idle.

On one card each replica runs on a CUDA stream of its own
(:class:`~repro_torch.serve.replica.Replica`), so one replica's kernels
can run while another replica's thread does host work. A graph that
arrives on the card carries an event recorded on the submitting thread's
current stream as the router pulls it; staging waits on it before
reading the graph.

**Replicas on sub-meshes.** An engine list whose engines are sharded
(``repro_torch.dist.make_sharded_engine``), each on its own sub-mesh of a
``torch.distributed`` world (``dist.make_bp_mesh(ranks=...)``; the meshes
disjoint, their union the world), makes the tier span processes. Every
rank builds the same meshes and engines and calls ``Router(engines, ...)``
and ``serve(stream)`` with the same stream; a rank runs only the replica
whose mesh holds it.

- **World rank 0 is the front**: it pulls the stream, routes through the
  unchanged policies, keeps every inbox, arbitrates steals
  (``_steal_for``, local to it), merges every replica's records in
  completion order and keeps ``RouterStats``. It also leads its own
  replica, on a thread as above. A ``RemoteReplica`` stands for each other
  replica, and one thread (``_desk``) owns the channel to their leaders.
- **A replica's leader** (its mesh's rank 0) runs the replica: it pulls
  its requests from the front, takes their graphs from its own copy of the
  stream by rid, takes the group's serving decisions (``core.serving``),
  reports its load after each cycle and sends its records to the front on
  the host.
- **A follower** runs the same pipeline over the stream and applies its
  leader's decisions.
- **Records.** The front's ``RouterResult`` holds every record, and
  ``serve`` yields every record there in completion order, as the
  reference's one process does; another rank's result holds its
  replica's records (the same on every rank of the group) and its stats
  only that replica's pipeline stats (``RouterStats.routed`` stays zero).
- **History and clocks.** One ``RoundsHistory`` cannot span processes:
  the front's feeds routing (``least_loaded``'s effort), from every
  replica's records, and each leader's feeds its own admission policy.
  Times are each process's ``clock`` (``perf_counter``: one host's
  monotonic clock), so ``t_route`` (the front's) and a record's stamps
  (its leader's) compare only on one host; a deadline leaves the front as
  a remaining budget. None of this moves a result bit, only where and when
  requests run.
"""

from __future__ import annotations

import dataclasses
import inspect
import queue as _queue
import threading
import time
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.batch import RoundsHistory, bucket_shape
from repro_torch.core.engine import BPConfig, BPEngine
from repro_torch.core.serving import AsyncServeStats, _entry_event
from repro_torch.serve.replica import (_CLOSED, _EMPTY, RemoteReplica,
                                       Replica, ReplicaLoad, RoutedRecord,
                                       _FrontLink, _Request, _take)
from repro_torch.serve.routing import RoutingPolicy, get_routing_policy

__all__ = ["Router", "RouterResult", "RouterStats", "serve_routed"]


@dataclasses.dataclass
class RouterStats:
    """Tier-level accounting: the routing ``policy`` name, whether
    ``steal`` was enabled, per-replica ``routed`` dispatch counts, and the
    stealing totals (``steals`` events moving ``stolen`` requests)."""

    policy: str
    steal: bool
    routed: List[int]
    steals: int = 0
    stolen: int = 0

    @property
    def replicas(self) -> int:
        """Replica count behind the router."""
        return len(self.routed)


@dataclasses.dataclass
class RouterResult:
    """``serve_routed`` output:
    :class:`~repro_torch.serve.replica.RoutedRecord`
    list in completion order, tier stats, and each replica's own
    ``AsyncServeStats`` (summed by the aggregate sweep properties)."""

    records: List[RoutedRecord]
    stats: RouterStats
    replica_stats: List[AsyncServeStats]    # on a sub-mesh's non-front
                                            # rank, its replica's alone

    @property
    def results(self) -> List:
        """Per-request ``BPResult`` list indexed by rid (input order for
        the usual dense 0..n-1 rids), matching ``AsyncServeResult.results``
        -- the replica fan-out is invisible here."""
        n = 1 + max((rec.rid for rec in self.records), default=-1)
        if n > 4 * len(self.records) + 64:
            raise ValueError(
                f"rids too sparse for a dense results list (max rid {n - 1} "
                f"over {len(self.records)} records); use .records instead")
        out: List = [None] * n
        for rec in self.records:
            out[rec.rid] = rec.result
        return out

    def by_replica(self) -> Dict[int, List[RoutedRecord]]:
        """Records grouped by serving replica (attribution view)."""
        out: Dict[int, List[RoutedRecord]] = {}
        for rec in self.records:
            out.setdefault(rec.replica, []).append(rec)
        return out

    def latency_percentiles(
            self, qs: Sequence[float] = (50, 90, 99), *,
            field: str = "latency",
            status: "str | None" = None) -> Dict[str, float]:
        """Tier-level latency percentiles in ms, ``{"p50": ...}``, measured
        from ``t_route`` (router queue-in) so routing and inbox wait are
        included: ``"latency"`` (route -> result), ``"admission"``
        (route -> bucket admit), or ``"service"`` (admit -> result).
        ``status`` filters to ``"completed"`` or ``"evicted"`` records
        (``None`` = all) -- deadline eviction makes raw percentiles lie
        (an evicted straggler *shrinks* them), so SLA reporting should
        pass ``status="completed"``. All-NaN when nothing matches."""
        attrs = {"latency": "latency_s", "admission": "queue_s",
                 "service": "service_s"}
        if field not in attrs:
            raise KeyError(f"field must be one of {sorted(attrs)}, "
                           f"got {field!r}")
        if status not in (None, "completed", "evicted"):
            raise ValueError("status must be None, 'completed', or "
                             f"'evicted', got {status!r}")
        recs = self.records if status is None else [
            r for r in self.records if r.status == status]
        if not recs:
            return {f"p{q:g}": float("nan") for q in qs}
        lat = np.array([getattr(r, attrs[field]) for r in recs]) * 1e3
        return {f"p{q:g}": float(np.percentile(lat, q)) for q in qs}

    @property
    def device_sweeps(self) -> int:
        """Total device sweeps across all replicas."""
        return sum(s.device_sweeps for s in self.replica_stats)

    @property
    def useful_sweeps(self) -> int:
        """Total sweeps spent on unconverged live graphs across replicas."""
        return sum(s.useful_sweeps for s in self.replica_stats)

    @property
    def wasted_sweeps(self) -> int:
        """Dead-slot / converged-graph sweeps across replicas -- the
        quantity work stealing exists to shrink."""
        return self.device_sweeps - self.useful_sweeps


class Router:
    """Multi-replica serving front-end (see module docstring).

    ``engine`` seeds the replica fleet: a ``BPConfig`` builds ``replicas``
    engines on ``device`` (default ``"cuda"``: with no GPU the constructor
    raises unless the caller passes ``device="cpu"``); a single
    ``BPEngine`` is the first replica's and the others are fresh engines of
    its config on its device; an explicit engine list pins one engine per
    replica, taken as given. ``rng`` is the shared base seed (an int or a
    ``torch.Generator``) from which every replica draws request ``rid``'s
    ``slot_generator(base, rid)``.

    ``routing`` picks the placement policy from the ``ROUTING_POLICIES``
    registry (``"round_robin"`` | ``"least_loaded"`` | ``"kind_affinity"``
    | ``"deadline"``, constructed with ``routing_kwargs``) or takes a
    prebuilt :class:`~repro_torch.serve.routing.RoutingPolicy`.
    ``steal=True`` enables
    watermark-triggered work stealing (``steal_batch`` requests at a time,
    victims keep ``low_watermark``). ``history`` pools effort calibration
    across replicas (one shared, internally locked
    :class:`~repro_torch.core.batch.RoundsHistory`; default: a fresh one).
    Remaining keyword arguments flow to every
    :class:`~repro_torch.serve.replica.Replica` and its pipeline (``slots``,
    ``max_batch``, ``admission``, ...).

    ``serve(stream)`` is a one-shot generator of
    :class:`~repro_torch.serve.replica.RoutedRecord` in completion order; a
    router is a context manager, and :func:`serve_routed` wraps the whole
    lifecycle for collect-everything callers.

    An engine list on sub-meshes (the module docstring) spans the world's
    processes: call the constructor and ``serve`` on every rank alike.
    ``front`` is True on world rank 0; ``index`` is the replica this rank
    runs (``None`` off a sub-mesh)."""

    def __init__(self, engine, rng, *,
                 replicas: int | None = None,
                 routing: "str | RoutingPolicy" = "round_robin",
                 routing_kwargs=None, steal: bool = False,
                 steal_batch: int = 4, low_watermark: int = 2,
                 inbox_capacity: int = 64, growth: float = 2.0,
                 history: RoundsHistory | None = None,
                 clock=None, device="cuda", **replica_kwargs):
        if isinstance(engine, (list, tuple)):
            engines = list(engine)
            if not engines:
                raise ValueError("need at least one engine")
            if replicas is not None and replicas != len(engines):
                raise ValueError(
                    f"replicas={replicas} but {len(engines)} engines given")
        else:
            n = 2 if replicas is None else replicas
            if n < 1:
                raise ValueError(f"replicas must be >= 1, got {n}")
            if isinstance(engine, BPConfig):
                engines = [BPEngine(engine, device=device) for _ in range(n)]
            elif isinstance(engine, BPEngine):
                engines = [engine] + [BPEngine(engine.config,
                                               device=engine.device)
                                      for _ in range(n - 1)]
            else:
                raise TypeError(
                    "engine must be a BPConfig, a BPEngine, or a sequence "
                    f"of BPEngines, got {type(engine).__name__}")
        if steal_batch < 1:
            raise ValueError(f"steal_batch must be >= 1, got {steal_batch}")
        ranks = _replica_ranks(engines)
        self.rng = rng
        self.growth = growth
        self.steal = steal
        self.steal_batch = steal_batch
        self._policy = get_routing_policy(
            routing, **dict(routing_kwargs or {})).bind(self)
        # Deadline-aware policies take an extra slo kwarg; inspect once so
        # the tier keeps working with legacy 3-arg pick signatures.
        params = inspect.signature(self._policy.pick).parameters
        self._pick_slo = "slo" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
        self.clock = clock if clock is not None else time.perf_counter
        if clock is not None:
            # One time source tier-wide: replica pipelines stamp
            # enqueue/admit/done on the router's clock, so absolute
            # deadlines compare across the thread boundary.
            replica_kwargs.setdefault("clock", clock)
        self._history = history if history is not None else RoundsHistory()
        self._out: _queue.Queue = _queue.Queue()
        self._steal_lock = threading.Lock()
        self.stats = RouterStats(policy=self._policy.name, steal=steal,
                                 routed=[0] * len(engines))
        kw = dict(out=self._out, history=self._history,
                  low_watermark=low_watermark, inbox_capacity=inbox_capacity,
                  growth=growth, **replica_kwargs)
        self._channel = None
        self._desk_thread: threading.Thread | None = None
        self.front, self.index = True, None
        if ranks is None:
            self.replicas = [
                Replica(eng, rng, index=i,
                        steal_fn=self._steal_for if steal else None, **kw)
                for i, eng in enumerate(engines)]
        else:
            import torch.distributed as dist
            from repro_torch.dist import comm
            me = dist.get_rank()
            self.index = next(k for k, r in enumerate(ranks) if me in r)
            self.front = me == 0
            leaders = sorted(r[0] for r in ranks)
            if len(leaders) > 1:        # every rank asks for the group
                self._channel = comm.Channel(comm.group_of(
                    leaders, "gloo", tag="channel"))
            mine = Replica(engines[self.index], rng, index=self.index,
                           steal_fn=(self._steal_for if steal and self.front
                                     else None), **kw)
            if self.front:
                self.replicas = [
                    mine if k == self.index else RemoteReplica(
                        k, r[0], history=self._history,
                        low_watermark=low_watermark,
                        inbox_capacity=inbox_capacity)
                    for k, r in enumerate(ranks)]
            else:
                self.replicas = [mine]
                if me == ranks[self.index][0]:
                    mine.link = _FrontLink(self._channel)
        self._arrival = 0
        self._live = 0
        self._explicit_rids = False
        self._seen_rids: set[int] = set()
        self._started = False
        self._closed = False

    # -- work stealing -----------------------------------------------------

    def _steal_for(self, thief: Replica) -> int:
        """Steal hook, called from a starving replica's source thread:
        transplant up to ``steal_batch`` requests from the tail of the
        deepest peer's inbox (victims keep their low watermark). The lock
        serializes concurrent thieves so two never split one victim's
        tail."""
        with self._steal_lock:
            victims = [r for r in self.replicas if r is not thief]
            victim = max(victims, key=lambda r: len(r._inbox), default=None)
            if victim is None or len(victim._inbox) <= victim.low_watermark:
                return 0
            reqs = victim.steal_from(self.steal_batch)
            if not reqs:
                return 0
            thief.steal_into(reqs)
            self.stats.steals += 1
            self.stats.stolen += len(reqs)
            return len(reqs)

    # -- loads -------------------------------------------------------------

    def loads(self) -> List[ReplicaLoad]:
        """One :class:`~repro_torch.serve.replica.ReplicaLoad` snapshot per
        replica (what routing policies see)."""
        return [r.load() for r in self.replicas]

    # -- the dispatch loop -------------------------------------------------

    def serve(self, stream: Iterable) -> Iterator[RoutedRecord]:
        """Dispatch ``stream`` across the replicas, yielding one
        :class:`~repro_torch.serve.replica.RoutedRecord` per request in
        completion order. One-shot: a Router serves one stream. The stream
        may yield ``PGM``\\ s (rid = arrival order), explicit
        ``(rid, PGM)`` pairs, or ``(rid, PGM, slo_s)`` deadline triples
        (``rid=None`` keeps arrival-order rids), exactly like
        ``serve_async``; replica results interleave as they complete.
        An SLO is seconds from *router* queue-in: the absolute deadline
        travels with the request (across steals too), and the replica
        charges routing + inbox wait against the budget. A graph on the GPU
        carries an event recorded on this thread's current stream as it is
        pulled (``serving._entry_event``). On a sub-mesh every rank passes
        the same stream; a rank other than the front yields its replica's
        records."""
        if self._started:
            raise ValueError("Router.serve is one-shot; build a fresh "
                             "Router per stream")
        if self._closed:
            raise ValueError("Router is closed")
        self._started = True
        if not self.front:
            yield from self._serve_replica(stream)
            return
        for r in self.replicas:
            r.start()
        self._live = len(self.replicas)
        if any(isinstance(r, RemoteReplica) for r in self.replicas):
            self._desk_thread = threading.Thread(
                target=self._desk, name="bp-router-desk", daemon=True)
            self._desk_thread.start()
        try:
            for item in iter(stream):
                t = self.clock()
                slo = None
                if isinstance(item, tuple):
                    if len(item) == 3:
                        rid, pgm, slo = item
                        slo = None if slo is None else float(slo)
                    else:
                        rid, pgm = item
                    if rid is None:
                        rid = self._arrival
                    else:
                        rid = int(rid)
                        self._explicit_rids = True
                else:
                    rid, pgm = self._arrival, item
                if self._explicit_rids:
                    if rid in self._seen_rids:
                        raise ValueError(
                            f"duplicate request id {rid} in stream")
                    self._seen_rids.add(rid)
                self._arrival += 1
                kind = bucket_shape(pgm, self.growth)
                if self._pick_slo:
                    i = self._policy.pick(rid, kind, self.loads(), slo=slo)
                else:
                    i = self._policy.pick(rid, kind, self.loads())
                if not 0 <= i < len(self.replicas):
                    raise ValueError(
                        f"routing policy picked replica {i}, have "
                        f"{len(self.replicas)}")
                self.stats.routed[i] += 1
                deadline = None if slo is None else t + slo
                self.replicas[i].submit(
                    _Request(rid, pgm, kind, t, deadline=deadline,
                             ready=_entry_event(pgm)))
                yield from self._drain(block=False)
            for r in self.replicas:
                r.finish()
            while self._live:
                yield from self._drain(block=True)
        finally:
            self.close()

    def _serve_replica(self, stream: Iterable) -> Iterator[RoutedRecord]:
        """A rank other than the front: run this rank's replica -- as its
        leader, pulling from the front, or as a follower -- over
        ``stream``, yielding its records."""
        mine, = self.replicas
        mine.requests = stream
        mine.start()
        self._live = 1
        try:
            while self._live:
                yield from self._drain(block=True)
        finally:
            self.close()

    def _dispatch(self, rep: RemoteReplica):
        """The front's answer to a pull of ``rep``'s leader: its next
        request (``("item", rid, remaining budget, (kind, stolen,
        t_route))``), ``("empty",)`` or ``("closed",)`` -- the rules of
        ``Replica._source`` (``replica._take``) on the front's inbox,
        stealing for it."""
        got = _take(rep, self._steal_for if self.steal else None, 0.0)
        if got is _CLOSED:
            return ("closed",)
        if got is _EMPTY:
            return ("empty",)
        slo = None if got.deadline is None else max(
            got.deadline - self.clock(), 0.0)
        return ("item", got.rid, slo, (got.kind, got.stolen, got.t_route))

    def _desk(self) -> None:
        """The front's end of the channel, on its own thread: answers the
        remote leaders' pulls, takes their load reports, their records
        (onto the output queue, the front's history fed) and their ends.
        An error ends every remote replica still live."""
        remote = {r.leader: r for r in self.replicas
                  if isinstance(r, RemoteReplica)}
        try:
            while remote:
                src, msg = self._channel.recv()
                rep = remote[src]
                if msg[0] == "pull":
                    rep.report(*msg[1:])
                    self._channel.send(self._dispatch(rep), src)
                elif msg[0] == "load":
                    rep.report(*msg[1:])
                elif msg[0] == "rec":
                    rec = msg[1]
                    rep.served += 1
                    if not rec.evicted:
                        self._history.observe(("routed", rec.kind), 0.0,
                                              float(rec.result.rounds))
                    self._out.put(("rec", rep.index, rec))
                else:                   # ("done", error text, stats)
                    rep.stats = msg[2]
                    del remote[src]
                    self._out.put(("done", rep.index, None if msg[1] is None
                                   else RuntimeError(
                                       f"replica {rep.index} (leader rank "
                                       f"{src}) failed:\n{msg[1]}")))
        except BaseException as e:      # surfaced on the router thread
            for rep in remote.values():
                self._out.put(("done", rep.index, e))

    def _drain(self, block: bool) -> Iterator[RoutedRecord]:
        """Pull completed records off the shared output queue: everything
        currently available, waiting for at most one item when ``block``.
        Replica errors re-raise here, on the router thread."""
        while True:
            try:
                tag, idx, payload = self._out.get(
                    block=block, timeout=0.2 if block else None)
            except _queue.Empty:
                return
            block = False
            if tag == "done":
                self._live -= 1
                if payload is not None:
                    raise payload
            else:
                yield payload

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Tear the tier down: close every replica (inbox, serving thread,
        pipeline + feeder threads all joined). Idempotent; also runs from
        ``serve``'s ``finally``, so an abandoned generator cannot leak
        replica threads."""
        if self._closed:
            return
        self._closed = True
        for r in self.replicas:
            r.close()
        if self._desk_thread is not None:
            # the remote leaders' next pulls are answered "closed"
            self._desk_thread.join(timeout=30.0)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Context-manager exit: ``close()`` -- all replica threads
        joined."""
        self.close()


def serve_routed(engine, stream, rng, *,
                 replicas: int | None = None,
                 routing: "str | RoutingPolicy" = "round_robin",
                 steal: bool = False, **kwargs) -> RouterResult:
    """Serve a request stream through a replica fleet and collect
    everything: builds a :class:`Router` (``engine`` is a ``BPConfig``,
    ``BPEngine``, or per-replica engine list; ``device`` and the remaining
    keyword arguments flow through), drains ``Router.serve`` to
    completion, and returns a
    :class:`RouterResult` -- records in completion order, ``.results`` in
    rid order, tier stats plus per-replica pipeline stats. The
    multi-replica analog of :func:`~repro_torch.core.serving.serve_async`."""
    with Router(engine, rng, replicas=replicas, routing=routing,
                steal=steal, **kwargs) as router:
        records = list(router.serve(stream))
        return RouterResult(
            records=records, stats=router.stats,
            replica_stats=[r.stats for r in router.replicas])


def _replica_ranks(engines) -> "List[Tuple[int, ...]] | None":
    """Each engine's mesh's global ranks when the engines are sharded (one
    sub-mesh a replica), or ``None`` when none is: the meshes must be
    disjoint, cover the world, and world rank 0 must lead its own."""
    meshes = [getattr(e.update_fn, "mesh", None) for e in engines]
    if all(m is None for m in meshes):
        return None
    if any(m is None for m in meshes):
        raise ValueError("a router's engines are all sharded, one sub-mesh "
                         "a replica, or none is")
    import torch.distributed as dist
    if not all(hasattr(m, "ranks") for m in meshes):
        raise ValueError("a router's sub-meshes are built by "
                         "repro_torch.dist.make_bp_mesh")
    ranks = [m.ranks for m in meshes]
    flat = sorted(r for rs in ranks for r in rs)
    if flat != list(range(dist.get_world_size())):
        raise ValueError(f"the replicas' meshes {ranks} must be disjoint "
                         f"and cover the world of {dist.get_world_size()} "
                         "ranks")
    if not any(r[0] == 0 for r in ranks):
        raise ValueError(f"world rank 0, the front, must be rank 0 of its "
                         f"replica's mesh: {ranks}")
    return ranks
