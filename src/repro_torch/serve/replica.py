"""Replica: one ``ServingPipeline`` on its own thread and its own CUDA
stream, behind a bounded inbound queue.

The port of ``repro.serve.replica``. A :class:`Replica` owns one
:class:`~repro_torch.core.serving.ServingPipeline` (and therefore one
``BPEngine``, on one device) plus a bounded :class:`_Inbox`
the router dispatches into. The replica thread drives the pipeline over an
inbox-draining source; every released ``RequestRecord`` is wrapped into a
:class:`RoutedRecord` (replica attribution, routing timeline, steal flag)
and pushed onto the router's shared output queue. :meth:`Replica.load`
returns a :class:`ReplicaLoad` snapshot -- inbox depth, staged width,
effort-in-flight calibrated by the shared
:class:`~repro_torch.core.batch.RoundsHistory` -- which is what routing
policies and the steal trigger read.

**Streams.** PyTorch's current stream is per thread, and on one card the
replicas overlap one another's work only if they launch on different
streams. So each replica thread runs its whole serving loop inside
``torch.cuda.stream(self.stream)``, a stream of its own on the engine's
device (``None`` on the CPU): the kernels launch on the current stream,
staging waits on its copy events from it, and every host read the engine
makes (the chunk-start budgets, the ``done`` polls, the slot syncs) waits
on that stream alone. Nothing on a replica's path synchronizes the whole
device. Before a record leaves the replica thread its stream is
synchronized, so the result tensors are finished for a consumer on any
other stream. Graphs that reach a replica from the card carry the event
the router recorded on the submitting thread's stream; the replica's
source has its pull wait on it, and staging waits on the pull's own event
(``repro_torch.core.serving``), so the graph is read after its producer.

**Replicas on sub-meshes** (``repro_torch.serve.router``): a replica
whose engine is sharded over a group of ranks runs in every process of the
group. Its leader (the group's rank 0) runs the ``Replica`` -- the feeder
and the source -- and its pipeline decides for the group
(``core.serving``); the followers run the same pipeline as followers over
their own copy of the stream. Only world rank 0, the front, holds the
inboxes: a leader in another process pulls its requests from the front
by a blocking request over a ``dist.comm.Channel`` (``_FrontLink``), and
the front keeps a :class:`RemoteReplica` as its stand-in (inbox, the load
the leader reports after each cycle, its stats at the end). The graph
itself never travels: every rank passes the same stream, and a rank takes
a request's graph from its own copy by rid. An absolute router-clock
deadline leaves the front as a *remaining* budget, and released records
come back to the front on the host.

Work stealing happens at the inbox boundary, *before* a request is staged:
when this replica's pending work (inbox + feeder buffer + staged) drains
below ``low_watermark``, its source invokes the router's steal hook, which
transplants a batch from the tail of the deepest peer's inbox into this
one. Stolen requests keep their rid (and therefore their
``slot_generator(base, rid)`` draws) and pad to the same deterministic
``bucket_shape`` ceilings on either side, so stealing never changes a
result bit -- it only changes *where* the sweeps run.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
import traceback
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import torch

from repro_torch.core.batch import RoundsHistory
from repro_torch.core.engine import BPEngine, BPResult
from repro_torch.core.graph import PGM
from repro_torch.core.serving import (AsyncServeStats, RequestRecord,
                                      ServingPipeline, _Provider)

__all__ = ["Replica", "ReplicaLoad", "RemoteReplica", "RoutedRecord"]

_CLOSED = object()
_EMPTY = object()

#: seconds a remote leader waits before asking again when its inbox at the
#: front is empty
PULL_POLL_S = 0.005


@dataclasses.dataclass
class _Request:
    """One routed request in flight: identity, payload, and routing-side
    metadata that must travel with it across steals."""
    rid: int
    pgm: PGM
    kind: Tuple[int, ...]       # bucket_shape ceilings (the shape family)
    t_route: float              # when the router pulled it from the stream
    stolen: bool = False
    deadline: float | None = None   # absolute (router clock); travels with
                                    # the request across steals
    ready: "torch.cuda.Event | None" = None   # a graph made on the card:
                                    # the producer's stream at submission


@dataclasses.dataclass
class RoutedRecord:
    """One served request with replica attribution: the replica-local
    :class:`~repro_torch.core.serving.RequestRecord` plus which replica ran it,
    its bucket-shape ``kind``, whether it was work-stolen, and ``t_route``
    (when the *router* pulled it from the stream -- the tier-level queue-in,
    earlier than the replica-local ``t_enqueue``)."""

    replica: int
    kind: Tuple[int, ...]
    stolen: bool
    t_route: float
    record: RequestRecord

    @property
    def rid(self) -> int:
        """Request id (the index of its ``slot_generator``)."""
        return self.record.rid

    @property
    def result(self):
        """The request's ``BPResult``."""
        return self.record.result

    @property
    def latency_s(self) -> float:
        """Router queue-in -> result release, seconds (the tier-level
        end-to-end latency; includes routing and replica-inbox wait)."""
        return self.record.t_done - self.t_route

    @property
    def queue_s(self) -> float:
        """Router queue-in -> bucket admission, seconds (routing + inbox +
        admission wait)."""
        return self.record.t_admit - self.t_route

    @property
    def service_s(self) -> float:
        """Time resident in a bucket slot, seconds."""
        return self.record.service_s

    @property
    def status(self) -> str:
        """``"completed"`` or ``"evicted"`` (the replica-local record's
        status -- evicted requests carry partial beliefs)."""
        return self.record.status

    @property
    def evicted(self) -> bool:
        """True when the replica's admission policy gave up on this
        request (deadline eviction); the result is partial."""
        return self.record.evicted

    @property
    def within_slo(self) -> bool:
        """Completed within its latency budget (vacuously true without
        one). Delegates to the replica-local record: the budget the
        replica received already had routing + inbox wait charged against
        it, so this is the tier-level SLO verdict."""
        return self.record.within_slo


@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """Point-in-time load snapshot of one replica, the routing policies'
    input: ``inbox`` requests queued before the pipeline, ``staged``
    requests padded/prefetched inside it, ``in_flight`` resident in bucket
    slots, and ``effort`` -- pending depth weighted by expected rounds per
    request from the shared ``RoundsHistory`` (so two heavy requests read
    as more load than three light ones)."""

    replica: int
    inbox: int
    staged: int
    in_flight: int
    effort: float
    urgent: int = 0             # deadlined requests queued in the inbox

    @property
    def depth(self) -> int:
        """Unweighted pending request count (inbox + staged + in_flight)."""
        return self.inbox + self.staged + self.in_flight

    @property
    def weight(self) -> float:
        """What ``least_loaded`` minimizes: the effort-weighted depth."""
        return self.effort


def _load(index: int, inbox: "_Inbox", history: RoundsHistory | None,
          staged: int, in_flight: int) -> ReplicaLoad:
    """A :class:`ReplicaLoad`: each inbox request weighted by ``history``'s
    expected rounds for its kind (``RoundsHistory.mean`` falls back kind ->
    global -> 1.0 cold, so unobserved kinds assume the tier-wide average);
    staged/in-flight requests weigh the global fallback since their kinds
    are already device-committed. ``urgent`` counts deadlined inbox
    requests -- the deadline routing policy's signal."""
    snap = inbox.snapshot()
    fallback = 1.0 if history is None else history.mean(None, default=1.0)
    est = [fallback if history is None
           else history.mean(("routed", k), default=fallback)
           for k, _ in snap]
    effort = sum(est) + (staged + in_flight) * fallback
    return ReplicaLoad(replica=index, inbox=len(snap), staged=staged,
                       in_flight=in_flight, effort=effort,
                       urgent=sum(1 for _, d in snap if d is not None))


class _Inbox:
    """Bounded, stealable inbound queue (one lock + condition).

    ``put`` blocks while full (backpressure onto the router) unless
    ``force`` -- the steal path, which transplants work that was already
    admitted tier-wide. ``finish`` marks the stream complete: no more
    router puts, pops drain the remainder; ``close`` abandons outright.
    ``steal`` pops up to ``k`` requests from the *tail* (the newest --
    head order, and therefore the victim's own admission order, is
    preserved), never leaving the victim with fewer than ``leave``."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"inbox capacity must be >= 1, got {capacity}")
        self._capacity = capacity
        self._items: Deque[_Request] = deque()
        self._cond = threading.Condition()
        self._done = False
        self._dead = False

    def __len__(self) -> int:
        return len(self._items)

    @property
    def dead(self) -> bool:
        return self._dead

    def kinds(self) -> List[Tuple[int, ...]]:
        """The queued requests' bucket-shape kinds (snapshot)."""
        with self._cond:
            return [r.kind for r in self._items]

    def snapshot(self) -> "List[Tuple[Tuple[int, ...], float | None]]":
        """(kind, absolute deadline) per queued request -- what load
        introspection reads (deadline = None for un-SLO'd requests)."""
        with self._cond:
            return [(r.kind, r.deadline) for r in self._items]

    def put(self, req: _Request, *, force: bool = False) -> None:
        with self._cond:
            while (not force and len(self._items) >= self._capacity
                   and not self._done and not self._dead):
                self._cond.wait(0.05)
            if self._dead or (self._done and not force):
                raise ValueError("replica inbox is closed")
            self._items.append(req)
            self._cond.notify_all()

    def pop(self, timeout: float):
        """Head request, or ``_EMPTY`` after ``timeout`` with nothing
        available, or ``_CLOSED`` once abandoned / finished-and-drained."""
        with self._cond:
            if not self._items and not self._dead:
                self._cond.wait(timeout)
            if self._dead:
                return _CLOSED
            if self._items:
                req = self._items.popleft()
                self._cond.notify_all()
                return req
            return _CLOSED if self._done else _EMPTY

    def steal(self, k: int, leave: int) -> List[_Request]:
        """Remove up to ``k`` tail requests, keeping >= ``leave`` queued."""
        with self._cond:
            k = min(k, max(0, len(self._items) - leave))
            out = [self._items.pop() for _ in range(k)]
            out.reverse()
            if out:
                self._cond.notify_all()
            return out

    def finish(self) -> None:
        with self._cond:
            self._done = True
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._done = self._dead = True
            self._items.clear()
            self._cond.notify_all()


def _take(rep, steal, timeout: float):
    """The next request for replica ``rep`` from its inbox: the request,
    ``_EMPTY`` (nothing yet) or ``_CLOSED`` (no more). ``steal`` (the
    router's hook, or ``None``) is tried whenever ``rep``'s pending work is
    below its low watermark. Once the stream finished and the inbox
    drained, peers may still hold stealable work: stay while buckets are
    busy; once pending drains below the watermark, a steal that comes back
    empty means no peer is above *its* watermark -- and post-finish inboxes
    only shrink, so nothing more can arrive."""
    inbox = rep._inbox
    if steal is not None and not inbox.dead and \
            rep.pending() < rep.low_watermark:
        steal(rep)
    got = inbox.pop(timeout=timeout)
    if got is not _CLOSED:
        return got
    if inbox.dead or steal is None:
        return _CLOSED
    if rep.pending() >= rep.low_watermark:
        return _EMPTY
    if not steal(rep) and not len(inbox):
        return _CLOSED
    return _EMPTY


class _Routed:
    """What the router reaches on every replica, local or remote: the
    inbox it dispatches into and steals from, and the counters."""

    def __init__(self, index: int, low_watermark: int, inbox_capacity: int):
        self.index = index
        self.low_watermark = max(0, low_watermark)
        self._inbox = _Inbox(inbox_capacity)
        self.submitted = 0
        self.stolen_in = 0
        self.stolen_out = 0
        self.served = 0

    def submit(self, req: _Request) -> None:
        """Enqueue one routed request (router thread; blocks while the
        inbox is at capacity -- the tier's backpressure)."""
        self._inbox.put(req)
        self.submitted += 1

    def finish(self) -> None:
        """No more submissions: drain the inbox, serve what remains (and
        keep stealing from deeper peers), then exit."""
        self._inbox.finish()

    def steal_into(self, reqs: List[_Request]) -> None:
        """Transplant stolen requests into this inbox (steal hook side;
        bypasses the capacity bound -- the work was already admitted
        tier-wide)."""
        for r in reqs:
            r.stolen = True
            self._inbox.put(r, force=True)
        self.stolen_in += len(reqs)

    def steal_from(self, k: int) -> List[_Request]:
        """Give up to ``k`` tail requests, keeping ``low_watermark``."""
        out = self._inbox.steal(k, self.low_watermark)
        self.stolen_out += len(out)
        return out


class RemoteReplica(_Routed):
    """The front's stand-in for a replica whose leader, global rank
    ``leader``, is another process: the replica's inbox (routed into,
    stolen from, drained by the leader's pulls over the channel), the load
    the leader last reported (``report``: requests ahead of its device --
    feeder buffer plus staged --, staged, in flight) and the pipeline
    stats it sent at its end (``stats``)."""

    def __init__(self, index: int, leader: int, *,
                 history: RoundsHistory | None = None,
                 low_watermark: int = 2, inbox_capacity: int = 64):
        super().__init__(index, low_watermark, inbox_capacity)
        self.leader = leader
        self._history = history
        self._reported = (0, 0, 0)
        self.stats = AsyncServeStats()

    def start(self) -> "RemoteReplica":
        return self

    def close(self) -> None:
        """Abandon queued work: the leader's next pull is told to end."""
        self._inbox.close()

    def report(self, ahead: int, staged: int, in_flight: int) -> None:
        self._reported = (int(ahead), int(staged), int(in_flight))

    def pending(self) -> int:
        return len(self._inbox) + self._reported[0]

    def load(self) -> ReplicaLoad:
        return _load(self.index, self._inbox, self._history,
                     *self._reported[1:])


class _FrontLink:
    """A remote leader's end of the channel to the front (world rank 0):
    its pulls (each answered at once: a request, ``("empty",)`` or
    ``("closed",)``), its load reports, its records (on the host) and its
    end. A lock keeps one thread at a time on the channel; after ``done``
    every pull answers ``("closed",)``."""

    FRONT = 0

    def __init__(self, channel):
        self._ch = channel
        self._lock = threading.Lock()
        self._closed = False

    def _send(self, msg) -> None:
        with self._lock:
            if not self._closed:
                self._ch.send(msg, self.FRONT)

    def pull(self, ahead: int, staged: int, in_flight: int):
        with self._lock:
            if self._closed:
                return ("closed",)
            self._ch.send(("pull", ahead, staged, in_flight), self.FRONT)
            return self._ch.recv(self.FRONT)[1]

    def report(self, ahead: int, staged: int, in_flight: int) -> None:
        self._send(("load", ahead, staged, in_flight))

    def emit(self, rec: "RoutedRecord") -> None:
        res = rec.record.result
        host = BPResult(**{
            f.name: (lambda x: x.cpu() if isinstance(x, torch.Tensor)
                     else x)(getattr(res, f.name))
            for f in dataclasses.fields(BPResult)})
        self._send(("rec", dataclasses.replace(
            rec, record=dataclasses.replace(rec.record, result=host))))

    def done(self, error: str | None, stats: AsyncServeStats) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._ch.send(("done", error, stats), self.FRONT)


class Replica(_Routed):
    """One serving worker: a ``ServingPipeline`` driven on its own thread
    from a bounded inbox, emitting :class:`RoutedRecord`\\ s onto a shared
    output queue.

    ``engine`` may be any ``BPEngine``; the replica's stream is made on its
    device. ``rng`` must be the *router's shared base seed* (an int, or a
    ``torch.Generator`` whose ``initial_seed()`` is taken): request ``rid``
    draws from ``slot_generator(base, rid)``, so a request's trajectory is
    identical on every replica -- the property the determinism pin and
    work stealing both rest on.

    The pipeline always runs with ``ingest_threads >= 1``: the inbox-
    draining source blocks waiting for dispatches, and only a feeder
    thread may block without stalling resident buckets. ``ingest_queue``
    defaults small (2) so requests stay in the *inbox* -- stealable --
    rather than pre-pulled into the feeder buffer.

    Lifecycle: ``start()`` spawns the thread; ``finish()`` marks the
    stream complete (the replica drains and exits); ``close()`` abandons
    queued work, joins the replica thread, and closes the pipeline
    (joining its feeder threads). The router calls these; replicas are not
    usually driven by hand.

    On a sub-mesh the router sets ``link`` (a ``_FrontLink``) on a leader
    in another process than the front, and ``requests`` (the whole stream)
    on it and on a follower: the leader then pulls its requests from the
    front and takes their graphs from ``requests`` by rid, and a
    follower's pipeline follows its leader over ``requests``."""

    def __init__(self, engine: BPEngine, rng, *, index: int = 0,
                 out: "Optional[_queue.Queue]" = None,
                 history: RoundsHistory | None = None,
                 steal_fn: "Callable[[Replica], int] | None" = None,
                 low_watermark: int = 2, inbox_capacity: int = 64,
                 growth: float = 2.0, ingest_threads: int = 1,
                 ingest_queue: int | None = 2,
                 prefetch: int | None = 8, **pipeline_kwargs):
        if prefetch is None:
            raise ValueError(
                "a replica needs a finite prefetch (prefetch=None drains "
                "the stream eagerly, which would block on the live inbox)")
        admission = pipeline_kwargs.pop("admission", None)
        admission_kwargs = dict(
            pipeline_kwargs.pop("admission_kwargs", None) or {})
        if admission is None:
            admission = getattr(engine.config, "admission", "fifo")
            if not admission_kwargs:
                admission_kwargs = dict(
                    getattr(engine.config, "admission_kwargs", ()))
        if history is not None and admission in ("residual", "deadline"):
            # Pool effort calibration tier-wide: every replica's effort-
            # aware policy reads/writes one shared (internally locked)
            # history.
            admission_kwargs.setdefault("history", history)
        super().__init__(index, low_watermark, inbox_capacity)
        self.stream = (torch.cuda.Stream(engine.device)
                       if engine.device.type == "cuda" else None)
        self._history = history
        self._steal_fn = steal_fn
        self._out: _queue.Queue = out if out is not None else _queue.Queue()
        self.pipeline = ServingPipeline(
            engine, rng, growth=growth, prefetch=prefetch,
            ingest_threads=max(1, ingest_threads),
            ingest_queue=ingest_queue, admission=admission,
            admission_kwargs=admission_kwargs, **pipeline_kwargs)
        self.link: _FrontLink | None = None
        self.requests = None            # the whole stream, on a sub-mesh
        self._thread = threading.Thread(
            target=self._run, name=f"bp-replica-{index}", daemon=True)

    # -- router-facing surface --------------------------------------------

    def start(self) -> "Replica":
        """Spawn the serving thread; returns self so construction chains."""
        self._thread.start()
        return self

    @property
    def stats(self) -> AsyncServeStats:
        """The pipeline's stats."""
        return self.pipeline.stats

    def close(self, *, join_timeout: float = 5.0) -> None:
        """Abandon queued work and tear the replica down: close the inbox
        (the serving thread then drains out on its own -- its ``finally``
        closes the pipeline), join the serving thread, and finally
        ``pipeline.close()`` for the never-started case. Idempotent.

        Ordering matters: closing the pipeline *first* would drain the
        feeder queue -- including the exhaustion sentinel a serving thread
        blocked in ``feeder.get(block=True)`` is waiting for -- and strand
        it; closing the inbox first lets the source return and the
        shutdown flow through the normal exhaustion path."""
        self._inbox.close()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
        self.pipeline.close()

    # -- load introspection ------------------------------------------------

    def _staged(self) -> int:
        # Advisory cross-thread read: the serving thread may be inserting a
        # fresh group mid-sum (dict mutation during iteration).
        for _ in range(3):
            try:
                return self.pipeline._staged_count()
            except RuntimeError:
                continue
        return 0

    def _ahead(self) -> Tuple[int, int, int]:
        """(feeder buffer + staged, staged, in flight): this replica's
        requests between its inbox and its released results."""
        feeder = self.pipeline._feeder
        buffered = feeder._q.qsize() if feeder is not None else 0
        staged = self._staged()
        stats = self.pipeline.stats
        in_flight = max(0, int(stats.staged) - int(stats.evacuated) - staged)
        return buffered + staged, staged, in_flight

    def pending(self) -> int:
        """Requests queued ahead of the device: inbox + feeder buffer +
        staged (the steal trigger's watermark quantity)."""
        return len(self._inbox) + self._ahead()[0]

    def load(self) -> ReplicaLoad:
        """A :class:`ReplicaLoad` snapshot for routing decisions (see
        ``_load``)."""
        return _load(self.index, self._inbox, self._history,
                     *self._ahead()[1:])

    # -- the serving thread ------------------------------------------------

    def _source(self):
        """The pipeline's request iterator: drain the inbox, triggering a
        steal whenever pending work falls below the low watermark. Runs on
        the pipeline's ingest feeder thread, so blocking here never stalls
        resident buckets."""
        while True:
            got = _take(self, self._steal_fn, 0.05)
            if got is _CLOSED:
                return
            if got is _EMPTY:
                continue
            if got.ready is not None:
                # This pull's entry event (recorded by the feeder on its
                # current stream) must follow the graph's producer.
                torch.cuda.current_stream(got.pgm.device).wait_event(
                    got.ready)
            self.pipeline.tags[got.rid] = (got.kind, got.stolen, got.t_route)
            if got.deadline is None:
                yield got.rid, got.pgm, None
            else:
                # Absolute router-clock deadline back to a *remaining*
                # budget relative to the replica-local enqueue the pipeline
                # stamps (same clock tier-wide), so inbox wait counts
                # against the SLO.
                yield (got.rid, got.pgm,
                       max(got.deadline - self.pipeline.clock(), 0.0))

    def _pulled(self):
        """A remote leader's source: its requests pulled from the front
        (``link``), their graphs taken by rid from its copy of the whole
        stream (``requests``). Runs on the feeder thread."""
        provider = _Provider(iter(self.requests), self.pipeline._wait_s)
        while True:
            got = self.link.pull(*self._ahead())
            if got[0] == "closed":
                return
            if got[0] == "empty":
                time.sleep(PULL_POLL_S)
                continue
            _, rid, slo, tag = got
            pgm, ready = provider.take(rid)
            if ready is not None:
                torch.cuda.current_stream(pgm.device).wait_event(ready)
            self.pipeline.tags[rid] = tag
            yield rid, pgm, slo

    def _run(self) -> None:
        err: BaseException | None = None
        try:
            with torch.cuda.stream(self.stream):
                self._serve()
        except BaseException as e:    # surfaced on the router thread
            err = e
        finally:
            self.pipeline.close()
            if self.link is not None:
                try:
                    self.link.done(None if err is None else "".join(
                        traceback.format_exception(err)),
                        self.pipeline.stats)
                except RuntimeError as e:   # the front is gone (timeout)
                    err = err or e
            self._out.put(("done", self.index, err))

    def _serve(self) -> None:
        """The serving loop, on this replica's stream (``_run``): the
        inbox (or, on a sub-mesh, the front's pulls or the leader's
        decisions) in, routed records out."""
        if self.pipeline.role == "follower":
            source = self.requests
        elif self.link is not None:
            source = self._pulled()
            self.pipeline.on_cycle = lambda: self.link.report(*self._ahead())
        else:
            source = self._source()
        for rec in self.pipeline.serve(source):
            kind, stolen, t_route = self.pipeline.tags.pop(rec.rid)
            if self.stream is not None:
                # The record's tensors, finished for readers on any stream.
                self.stream.synchronize()
            if self._history is not None and not rec.evicted:
                # Evicted round counts are truncation artifacts, not
                # effort samples -- feeding them in would teach the
                # predictor that hard requests are cheap.
                self._history.observe(("routed", kind), 0.0,
                                      float(rec.result.rounds))
            self.served += 1
            routed = RoutedRecord(replica=self.index, kind=kind,
                                  stolen=stolen, t_route=t_route, record=rec)
            if self.link is not None:
                self.link.emit(routed)
            self._out.put(("rec", self.index, routed))
