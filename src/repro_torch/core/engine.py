"""Resumable BP engine: config-driven entry, chunked stepping, buckets.

The port of ``repro.core.engine``. The scheduling policy (LBP/RBP/RS/RnBP)
and everything else is one frozen, serializable ``BPConfig`` behind one
inference loop:

    engine = BPEngine(BPConfig(scheduler="rnbp",
                               scheduler_kwargs={"low_p": 0.4},
                               eps=1e-3, max_rounds=2000), device="cuda")
    res = engine.run(pgm, torch.Generator("cuda").manual_seed(0))
    results = engine.run_many(pgms, 0)      # bucketed stream, base seed 0

Chunked resume:

    state = engine.init(pgm, generator)     # BPState: every carried tensor
    while not engine.finished(state):
        state = engine.step(state)          # one chunk of <= chunk_rounds
    res = engine.result(state)

``step`` carries the *entire* trajectory (messages, scheduler state, the
generator's state, round/update counters, history), so N rounds through
repeated ``step`` are bitwise N rounds in one ``run``.

Every method also takes a ``BatchedPGM`` bucket: then every counter has a
leading (B,) axis, each graph draws from its own generator, and the message
update runs once per round on the bucket's disjoint union (the
``batch_backend``, or the single-graph ``backend`` on ``folded()``).

The reference runs a chunk as one ``lax.while_loop`` with ``done`` on the
device. Here the loop is Python over device tensors: counters stay on the
device, every round's effects are gated on a device-side ``active`` flag
(per graph on a bucket, as the reference's ``_chunk_batch`` gates them),
and the host reads ``done`` once per chunk start and then once every
``SYNC_ROUNDS`` rounds. Each graph's iteration budget for the chunk comes
from its rounds at chunk start and the chunk's limit, both known to the
host, so a graph never runs past its limit and every chunk boundary sees
exactly the generator state a monolithic run has there. Rounds run after
convergence inside a window are inert: they commit nothing and advance no
counter. A graph's trajectory in a bucket is therefore bitwise its solo
run on ``batch.graph(i)`` with the same generator.

``BPConfig`` keeps every field of the reference, so ``to_dict`` output is
identical across the two packages. ``serve`` serves a materialized
stream synchronously, a thin wrapper over
``repro_torch.core.serving.serve_async``; the
config's ``admission``/``admission_kwargs`` pick its admission policy.
``scheduler="srbp"`` selects the paper's host-serial baseline
(``repro_torch.core.serial``): ``run`` only, and it returns an
``SRBPResult``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import messages as M
from repro_torch.core.batch import (BatchedPGM, batch_generators, bucket_pgms,
                                    slot_generator)
from repro_torch.core.graph import PGM, resolve_device
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.schedulers.base import Scheduler

__all__ = ["BPConfig", "BPEngine", "BPResult", "BPState", "ServeResult",
           "ServeStats", "SYNC_ROUNDS"]

#: rounds between host reads of ``done`` inside a chunk
SYNC_ROUNDS = 16


# --------------------------------------------------------------- results --

@dataclasses.dataclass(frozen=True)
class BPResult:
    """Finished-trajectory record returned by ``BPEngine.run``/``result``.

    ``converged`` is True iff every real edge's residual fell below the
    config's ``eps`` within ``max_rounds`` sweeps; ``beliefs`` are valid
    either way (the best marginals at exit). Counters are 0-d tensors on
    the graph's device; on a bucket every field has a leading (B,) axis.
    """

    beliefs: torch.Tensor       # (V, S) log-marginals
    logm: torch.Tensor          # (E, S) final messages
    rounds: torch.Tensor        # () int32: bulk sweeps executed
    updates: torch.Tensor       # () int64: committed messages (exact count)
    converged: torch.Tensor     # () bool
    max_residual: torch.Tensor  # () f32 at exit
    unconverged_history: torch.Tensor  # (max_rounds,) int32, -1 past exit
    sched_state: Any            # scheduler carry


# ---------------------------------------------------------------- config --

def _freeze_kwargs(kw) -> Tuple[Tuple[str, Any], ...]:
    if isinstance(kw, Mapping):
        return tuple(sorted(kw.items()))
    return tuple(kw)


@dataclasses.dataclass(frozen=True)
class BPConfig:
    """Frozen, hashable inference config; the engine's single entry knob.

    Fields, defaults and validation are the reference's, and ``to_dict``
    gives the same dict, so a config serialized by either package loads in
    the other. ``scheduler`` is a registry spec string ("lbp"/"rbp"/"rs"/
    "rnbp") or a prebuilt ``Scheduler``; ``scheduler_kwargs`` feed its
    constructor. ``backend`` names the message update ("ref" | "maxprod" |
    "triton" | "pallas" | "sharded", through
    ``repro_torch.kernels.ops.UPDATE_BACKENDS``)
    or is a ``(pgm, logm) -> (cand, resid)`` callable. A bucket folds into
    its disjoint union and runs ``backend`` there; ``batch_backend``
    optionally names a batched backend instead ("pallas" | "triton", each
    that fold through the backend of its name, or one registered with
    ``register_update_backend(name, batched=True)``, through
    ``repro_torch.kernels.ops.BATCH_UPDATE_BACKENDS``) or is a natively
    batched ``(batch, logm) -> (cand, resid)`` callable.
    ``chunk_rounds`` bounds rounds per ``step`` (None = to ``max_rounds``
    in one chunk); ``history`` sizes the per-round unconverged-count
    buffer. ``admission`` names the serving path's admission policy
    ("fifo" | "residual" | "windowed" | "deadline", through
    ``repro_torch.core.serving.ADMISSION_POLICIES``) or is a policy
    instance; ``admission_kwargs`` feed its constructor.
    """

    scheduler: Any = "lbp"
    scheduler_kwargs: Any = ()
    eps: float = 1e-3
    max_rounds: int = 2000
    damping: float = 0.0
    backend: Any = "ref"
    batch_backend: Any = None
    chunk_rounds: int | None = None
    history: bool = True
    admission: Any = "fifo"
    admission_kwargs: Any = ()

    def __post_init__(self):
        object.__setattr__(self, "scheduler_kwargs",
                           _freeze_kwargs(self.scheduler_kwargs))
        object.__setattr__(self, "admission_kwargs",
                           _freeze_kwargs(self.admission_kwargs))
        if not self.eps > 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if self.max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {self.max_rounds}")
        if not 0.0 <= self.damping < 1.0:
            raise ValueError(f"damping must be in [0, 1), got {self.damping}")
        if self.chunk_rounds is not None and self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1 or None, got "
                             f"{self.chunk_rounds}")

    def make_scheduler(self) -> Scheduler:
        """The configured ``Scheduler`` instance."""
        return get_scheduler(self.scheduler, **dict(self.scheduler_kwargs))

    def to_dict(self) -> dict:
        """JSON-ready form. Requires a string (or registered) scheduler spec
        and string backends -- the serializable subset."""
        from repro_torch.core.schedulers import scheduler_spec
        d = dataclasses.asdict(self)
        if not isinstance(self.scheduler, str):
            name, kw = scheduler_spec(self.scheduler)
            d["scheduler"], d["scheduler_kwargs"] = name, _freeze_kwargs(kw)
        for f in ("backend", "batch_backend"):
            if d[f] is not None and not isinstance(d[f], str):
                raise ValueError(f"{f} is a callable; not serializable")
        if not isinstance(d["admission"], str):
            raise ValueError("admission is a policy instance; use a registry "
                             "spec string for a serializable config")
        d["scheduler_kwargs"] = dict(d["scheduler_kwargs"])
        d["admission_kwargs"] = dict(d["admission_kwargs"])
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "BPConfig":
        """Inverse of ``to_dict``."""
        return cls(**dict(d))


# ----------------------------------------------------------------- state --

@dataclasses.dataclass(frozen=True)
class BPState:
    """Resumable trajectory state -- everything a chunk boundary carries.

    Counters are 0-d tensors on the graph's device, (B,) on a bucket;
    ``rng`` is the state of the run's ``torch.Generator``
    (``Generator.get_state()``), a tuple of B such states on a bucket, so a
    resumed state draws exactly what an uninterrupted run would.
    ``chunk_iters`` is bookkeeping (rounds of the last ``step`` in which
    some graph was active), not trajectory.
    """

    graph: Any                  # PGM | BatchedPGM
    logm: torch.Tensor          # (E, S) / (B, E, S); a rank's (E/n, S)
    sched_state: Any            # scheduler carry
    rng: Any                    # generator state (uint8, host) / B of them
    rounds: torch.Tensor        # () / (B,) int32 cumulative rounds
    done: torch.Tensor          # () / (B,) bool convergence
    updates: torch.Tensor       # () / (B,) int64 committed messages
    unconverged_history: torch.Tensor  # (H,) / (B, H) int32
    max_residual: torch.Tensor  # () / (B,) f32
    chunk_iters: torch.Tensor   # () int32, diagnostics only

    @property
    def batched(self) -> bool:
        """True for a bucket's state."""
        return isinstance(self.graph, BatchedPGM)

    def messages_numpy(self) -> np.ndarray:
        """The current (E, S) messages as a host numpy array -- with
        ``BPEngine.init(..., logm=...)`` the bridge that resumes one
        package's trajectory in the other. On a rank-resident state
        (``repro_torch.dist``) the whole messages, gathered (a
        collective)."""
        if getattr(self.graph, "rank_resident", False):
            return self.graph.gather(self.logm).cpu().numpy()
        return self.logm.cpu().numpy()


def _where_tree(active: torch.Tensor, new, old):
    if new is old or not isinstance(new, torch.Tensor):
        return new      # () or unchanged carries: nothing to gate
    # (B,) flags against a (B,) or (B, E) carry
    return torch.where(active.reshape(active.shape + (1,) * (
        new.dim() - active.dim())), new, old)


# --------------------------------------------------------- serving loop --

@dataclasses.dataclass
class ServeStats:
    """Sweep accounting for ``BPEngine.serve``.

    Sweeps are counted in *masked update passes per graph slot* (one loop
    iteration of a B-wide bucket = B device sweeps x ``inner_sweeps``);
    ``useful_sweeps`` counts only rounds advanced on live graphs, so
    ``wasted_sweeps`` is exactly the straggler/padding overhead evacuation
    is meant to shrink."""

    chunks: int = 0
    device_sweeps: int = 0
    useful_sweeps: int = 0
    evacuated: int = 0
    backfilled: int = 0
    #: (chunk index at evacuation, input graph index) per evacuated graph
    evacuation_log: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def wasted_sweeps(self) -> int:
        return self.device_sweeps - self.useful_sweeps


@dataclasses.dataclass
class ServeResult:
    """``BPEngine.serve`` output: one ``BPResult`` per request (input
    order, each sliced to single-graph shapes) plus the run's sweep
    accounting (``ServeStats``)."""

    results: List[BPResult]     # per-request, input order
    stats: ServeStats


# ---------------------------------------------------------------- engine --

def _put(full: torch.Tensor, j: int, value) -> torch.Tensor:
    """A copy of ``full`` with row ``j`` set to ``value``."""
    out = full.clone()
    out[j] = value
    return out


def _row(x, j: int):
    return x[j] if isinstance(x, torch.Tensor) else x


class BPEngine:
    """The BP inference engine (see module docstring).

    One engine = one resolved (scheduler, backend, batch backend) triple on
    one device. Every method takes a ``PGM`` or a ``BatchedPGM`` bucket;
    ``run_many`` takes a heterogeneous graph list. ``device`` defaults to
    ``"cuda"``; with no GPU the constructor raises unless the caller passes
    ``device="cpu"``.
    """

    def __init__(self, config: BPConfig | None = None, *, device="cuda",
                 **overrides):
        config = config or BPConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = resolve_device(device)
        self.is_serial = (isinstance(config.scheduler, str)
                          and config.scheduler.lower() == "srbp")
        self.scheduler: Scheduler | None = (
            None if self.is_serial else config.make_scheduler())
        from repro_torch.kernels.ops import get_update_fn
        backend, batch_backend = config.backend, config.batch_backend
        self.update_fn = (backend if callable(backend)
                          else get_update_fn(backend))
        # The sharded backend (repro_torch.dist) makes graphs rank-resident.
        self._place = getattr(self.update_fn, "place", None)
        if self._place is not None and batch_backend is not None:
            raise ValueError(
                "the sharded backend folds a bucket into its rank-resident "
                f"union itself; batch_backend must be None, got "
                f"{batch_backend!r}")
        if batch_backend is None:
            # Mesh-aware fold: a sharded backend (repro_torch.dist)
            # advertises its mesh, and the union keeps the rank's slice.
            mesh = getattr(self.update_fn, "mesh", None)
            axis = getattr(self.update_fn, "axis", "bp")
            self.batch_update_fn = lambda batch, logm: batch.folded_update(
                self.update_fn, logm, mesh=mesh, axis=axis)
        elif callable(batch_backend):
            self.batch_update_fn = batch_backend
        else:
            self.batch_update_fn = get_update_fn(batch_backend, batched=True)

    def _check_graph(self, graph):
        if not isinstance(graph, (PGM, BatchedPGM)):
            raise TypeError(f"BPEngine runs a PGM or a BatchedPGM, got "
                            f"{type(graph).__name__}")
        if getattr(graph, "rank_resident", False) and self._place is None:
            raise ValueError(
                "a rank-resident graph holds one rank's slice "
                "(repro_torch.dist); it runs only on the sharded backend")
        dev = graph.device
        if dev.type != self.device.type or (
                self.device.index is not None and dev != self.device):
            raise ValueError(f"graph is on {graph.device}, engine on "
                             f"{self.device}")
        return graph

    @staticmethod
    def _check_generator(rng, device) -> torch.Generator:
        if not isinstance(rng, torch.Generator):
            raise TypeError("rng must be a torch.Generator on the graph's "
                            f"device, got {type(rng).__name__}")
        if rng.device.type != device.type:
            raise ValueError(f"generator is on {rng.device}, graph on "
                             f"{device}")
        return rng

    def _refuse_serial(self) -> None:
        if self.is_serial:
            raise NotImplementedError(
                "scheduler='srbp' is host-serial: use run(), not init/step")

    def _update(self, graph) -> Callable:
        """``logm -> (cand, resid)`` for one graph or a whole bucket."""
        if not isinstance(graph, BatchedPGM):
            return lambda logm: self.update_fn(graph, logm)
        return lambda logm: self.batch_update_fn(graph, logm)

    # -- lifecycle ---------------------------------------------------------

    def init(self, graph: PGM | BatchedPGM, rng, *, logm=None) -> BPState:
        """Fresh trajectory state for ``graph``. ``rng`` is a
        ``torch.Generator`` on the graph's device; its state is copied, not
        advanced. For a bucket it is one generator per graph, or one
        generator (or int) as the base seed of per-slot generators
        (``batch.batch_generators``). ``logm`` optionally replaces the
        uniform initial messages ((E, S) or (B, E, S) numpy array or
        tensor), e.g. to resume a trajectory that the reference package
        started."""
        self._refuse_serial()
        if self._place is not None:
            graph = self._place(graph, self.device)
        g = self._check_graph(graph)
        dev = g.device
        batched = isinstance(g, BatchedPGM)
        if batched:
            gens = [self._check_generator(r, dev)
                    for r in batch_generators(rng, g.size, dev)]
            lead = (g.size,)
            init_logm = lambda: M.init_messages(g.folded()).reshape(
                g.size, g.n_edges, g.n_states_max)
            sstate = self.scheduler.init_batch(g)
            rng_state = tuple(r.get_state().clone() for r in gens)
        else:
            lead = ()
            init_logm = lambda: M.init_messages(g)
            sstate = self.scheduler.init(g)
            rng_state = self._check_generator(rng, dev).get_state().clone()
        resident = getattr(g, "rank_resident", False)
        if logm is None:
            logm = g.init_messages() if resident else init_logm()
        else:
            if not isinstance(logm, torch.Tensor):
                logm = torch.tensor(np.asarray(logm))      # a copy
            shape = lead + (g.n_edges, g.n_states_max)
            if tuple(logm.shape) != shape:
                raise ValueError(f"logm must be {shape}, got "
                                 f"{tuple(logm.shape)}")
            logm = (g.local(logm) if resident else logm.to(
                device=dev, dtype=torch.float32).contiguous())
        hist_len = self.config.max_rounds if self.config.history else 1
        return BPState(
            graph=g, logm=logm, sched_state=sstate, rng=rng_state,
            rounds=torch.zeros(lead, dtype=torch.int32, device=dev),
            done=torch.zeros(lead, dtype=torch.bool, device=dev),
            updates=torch.zeros(lead, dtype=torch.int64, device=dev),
            unconverged_history=torch.full(lead + (hist_len,), -1,
                                           dtype=torch.int32, device=dev),
            max_residual=torch.full(lead, float("inf"), dtype=torch.float32,
                                    device=dev),
            chunk_iters=torch.zeros((), dtype=torch.int32, device=dev))

    def step(self, state: BPState, *,
             chunk_rounds: int | None = None) -> BPState:
        """Advance one chunk: at most ``chunk_rounds`` further rounds per
        graph, stopping early on convergence. A finished state is a no-op.
        Bitwise equal to running the same total rounds in one chunk."""
        self._refuse_serial()
        cfg, sched = self.config, self.scheduler
        graph = self._check_graph(state.graph)
        batched = isinstance(graph, BatchedPGM)
        chunk = chunk_rounds or cfg.chunk_rounds or cfg.max_rounds
        inner = sched.inner_sweeps
        # Host reads at chunk start: each graph's iteration budget.
        budgets = []
        for r0, d0 in zip(state.rounds.reshape(-1).tolist(),
                          state.done.reshape(-1).tolist()):
            limit = min(r0 + chunk, cfg.max_rounds)
            budgets.append(0 if d0 or r0 >= limit
                           else -(-(limit - r0) // inner))
        n_iters = max(budgets)
        if n_iters == 0:
            return dataclasses.replace(state, chunk_iters=torch.zeros_like(
                state.chunk_iters))
        dev = graph.device
        states = state.rng if batched else (state.rng,)
        gens = [torch.Generator(device=dev) for _ in states]
        for g, st in zip(gens, states):
            g.set_state(st)
        budget = torch.tensor(budgets, dtype=torch.int32, device=dev)
        if not batched:
            budget = budget[0]
        update = self._update(graph)
        edge_mask = graph.pgm.edge_mask if batched else graph.edge_mask
        eps = cfg.eps
        # A rank-resident graph's messages are the rank's flat slice
        # (repro_torch.dist): it commits that slice of the frontier.
        span = getattr(graph, "span", None)

        logm, sstate = state.logm, state.sched_state
        rounds, done, updates = state.rounds, state.done, state.updates
        hist, max_r = state.unconverged_history, state.max_residual
        iters = torch.zeros_like(state.chunk_iters)
        hist_last = hist.shape[-1] - 1
        for it in range(n_iters):
            active = ~done & (budget > it)
            cand, r = update(logm)
            unconverged = ((r >= eps) & edge_mask).sum(dim=-1).to(
                torch.int32)
            if batched:
                live = [g if it < b else None for g, b in zip(gens, budgets)]
                frontier, new_sstate = sched.select_batch(
                    graph, r, eps, live, sstate, unconverged)
            else:
                frontier, new_sstate = sched.select(graph, r, eps, gens[0],
                                                    sstate, unconverged)
            sstate = _where_tree(active, new_sstate, sstate)
            # Converged -> commit nothing (IsConverged precedes Update).
            newly_done = (unconverged == 0) & active
            frontier = frontier & (active & ~newly_done)[..., None]
            commit = frontier if span is None else \
                frontier.reshape(-1)[slice(*span)]
            logm = M.apply_frontier(logm, cand, commit, cfg.damping)
            for _ in range(inner - 1):     # Residual Splash's extra sweeps
                cand, _ = update(logm)
                logm = M.apply_frontier(logm, cand, commit, cfg.damping)
            updates = updates + frontier.sum(dim=-1) * inner
            if cfg.history:
                idx = torch.clamp(rounds, max=hist_last).long()[..., None]
                hist = hist.scatter(-1, idx, torch.where(
                    active, unconverged, hist.gather(-1, idx)[..., 0]
                )[..., None])
            rounds = rounds + torch.where(
                newly_done | ~active, 0, inner).to(torch.int32)
            max_r = torch.where(active, r.amax(dim=-1), max_r)
            iters = iters + active.any().to(torch.int32)
            done = done | newly_done
            if (it + 1) % SYNC_ROUNDS == 0 and it + 1 < n_iters and \
                    bool((done | (budget <= it + 1)).all()):
                break
        rng = tuple(g.get_state() for g in gens)
        return dataclasses.replace(
            state, logm=logm, sched_state=sstate,
            rng=rng if batched else rng[0], rounds=rounds, done=done,
            updates=updates, unconverged_history=hist, max_residual=max_r,
            chunk_iters=iters)

    def finished(self, state: BPState) -> bool:
        """True when every graph converged or exhausted ``max_rounds``."""
        return bool((state.done | (state.rounds >= self.config.max_rounds))
                    .all())

    def result(self, state: BPState) -> BPResult:
        """Finalize a state into a ``BPResult`` (computes beliefs). On a
        rank-resident state the beliefs come from the chain fold and the
        messages are gathered whole, so every rank returns the same
        result."""
        g, logm = state.graph, state.logm
        if getattr(g, "rank_resident", False):
            beliefs, logm = g.beliefs(logm), g.gather(logm)
        elif isinstance(g, BatchedPGM):
            beliefs = M.beliefs(g.folded(), logm.reshape(
                -1, g.n_states_max)).reshape(g.size, g.n_vertices, -1)
        else:
            beliefs = M.beliefs(g, logm)
        return BPResult(beliefs=beliefs,
                        logm=logm, rounds=state.rounds,
                        updates=state.updates, converged=state.done,
                        max_residual=state.max_residual,
                        unconverged_history=state.unconverged_history,
                        sched_state=state.sched_state)

    def load_slot(self, state: BPState, j: int, graph: PGM,
                  rng: torch.Generator) -> BPState:
        """Replace slot ``j`` of a bucket's state with a fresh ``graph``
        (padded to the bucket's shape; its counts must fit the bucket's
        ceilings) and reset that slot's trajectory -- messages, scheduler
        state, counters, generator -- exactly as ``init`` would for a solo
        run of ``new_batch.graph(j)`` with ``rng``. The other slots carry
        on unchanged. (The reference's ``_load_slot``.)"""
        if not state.batched:
            raise TypeError("load_slot needs a bucket's state (BatchedPGM)")
        if getattr(state.graph, "rank_resident", False):
            batch, logm = state.graph.with_slot(state.logm, j, graph)
        else:
            batch = state.graph.with_graph(j, graph)
            logm = _put(state.logm, j, M.init_messages(batch.graph(j)))
        elem = batch.graph(j)
        gen = self._check_generator(rng, batch.device)
        sstate = self.scheduler.init(elem)
        return dataclasses.replace(
            state, graph=batch, logm=logm,
            sched_state=(_put(state.sched_state, j, sstate)
                         if isinstance(sstate, torch.Tensor)
                         else state.sched_state),
            rng=state.rng[:j] + (gen.get_state().clone(),) + state.rng[j + 1:],
            rounds=_put(state.rounds, j, 0), done=_put(state.done, j, False),
            updates=_put(state.updates, j, 0),
            unconverged_history=_put(state.unconverged_history, j, -1),
            max_residual=_put(state.max_residual, j, float("inf")))

    # -- one-shot ----------------------------------------------------------

    def run(self, graph: PGM | BatchedPGM, rng=None, *,
            state: BPState | None = None) -> BPResult:
        """One-shot inference, chunk by chunk when ``chunk_rounds`` is set
        (same trajectory either way). ``state`` resumes an existing
        trajectory instead of starting fresh. For ``scheduler='srbp'`` runs
        the host-serial baseline and returns an ``SRBPResult``."""
        if self.is_serial:
            from repro_torch.core.serial import srbp_run
            kw = dict(self.config.scheduler_kwargs)
            return srbp_run(self._check_graph(graph), eps=self.config.eps,
                            **kw)
        if state is None:
            if rng is None:
                raise ValueError("run() needs an rng (a torch.Generator) or "
                                 "a state")
            state = self.init(graph, rng)
        while not self.finished(state):
            state = self.step(state)
        return self.result(state)

    def run_many(self, pgms: Sequence[PGM], rng, *, growth: float = 2.0,
                 max_batch: int | None = None) -> List[BPResult]:
        """Bucket ``pgms`` (shape-homogeneous padded batches), run each
        bucket, return per-graph results in input order. ``rng`` is a base
        seed (an int, or a ``torch.Generator`` whose ``initial_seed()`` is
        taken); graph ``i`` draws from ``slot_generator(base, i)``, so the
        results do not depend on ``growth``/``max_batch`` beyond the padded
        shape each graph gets. (RnBP draws over the *padded* edge axis, so
        a bucketing change that re-pads a graph can change its trajectory
        -- the fixed point reached, not the answer quality. The draws are
        not JAX's threefry: ROADMAP queue 1, item 4.)"""
        base = rng.initial_seed() if isinstance(rng, torch.Generator) \
            else int(rng)
        results: List[BPResult | None] = [None] * len(pgms)
        buckets = bucket_pgms(pgms, growth=growth, max_batch=max_batch)
        buckets.reverse()
        while buckets:
            bucket = buckets.pop()
            indices, batch = bucket.indices, bucket.batch
            if self._place is not None:
                # the whole bucket goes as soon as the rank holds its slice
                batch = self._place(batch, self.device)
            del bucket
            gens = [slot_generator(base, i, self.device) for i in indices]
            res = self.run(batch, gens)
            for j, gi in enumerate(indices):
                results[gi] = BPResult(**{
                    f.name: _row(getattr(res, f.name), j)
                    for f in dataclasses.fields(BPResult)})
        return results  # type: ignore[return-value]

    # -- serving with evacuation ------------------------------------------

    def _slice_result(self, state: BPState, j: int) -> BPResult:
        """Slot ``j`` of a bucket's state as a single-graph ``BPResult``:
        beliefs on ``graph.graph(j)``, every field a copy (a released
        request does not keep the bucket's tensors alive)."""
        row = lambda x: x[j].clone()                         # noqa: E731
        g = state.graph
        if getattr(g, "rank_resident", False):  # collectives, in order
            logm = g.slot_messages(state.logm, j)
            beliefs = g.slot_beliefs(state.logm, j)
        else:
            logm = row(state.logm)
            beliefs = M.beliefs(g.graph(j), logm)
        sstate = state.sched_state
        return BPResult(
            beliefs=beliefs, logm=logm,
            rounds=row(state.rounds), updates=row(state.updates),
            converged=row(state.done), max_residual=row(state.max_residual),
            unconverged_history=row(state.unconverged_history),
            sched_state=(row(sstate) if isinstance(sstate, torch.Tensor)
                         else sstate))

    def serve(self, stream: Sequence[PGM], rng, *, growth: float = 2.0,
              max_batch: int | None = None, chunk_rounds: int | None = None,
              evacuate: bool = True) -> ServeResult:
        """Serve a materialized request stream through rolling, evacuating
        buckets -- the synchronous wrapper over ``repro_torch.core.serving``
        (one resident bucket, no compaction, stream staged up front).

        Requests are grouped by bucket shape key and padded to their
        *group's* joint ceiling; each group runs as one resident batch of
        width ``min(max_batch, group size)``. After every chunk, converged
        (or round-exhausted) graphs are evacuated -- their results released
        -- and their slots backfilled from the group's pending queue.
        ``evacuate=False`` runs every bucket to completion over the same
        padded groups.

        ``rng`` is a base seed (an int, or a ``torch.Generator`` whose
        ``initial_seed()`` is taken); request ``i`` draws from
        ``slot_generator(base, i)``, as under ``run_many``, so results
        match ``run_many`` bitwise whenever the padded shapes coincide
        (always for same-shape groups) and do not depend on ``max_batch``
        or ``evacuate``. The config's ``admission`` policy applies. For
        online iterators, two resident buckets, compaction and threaded
        ingestion use ``serving.serve_async``."""
        from repro_torch.core.serving import serve_async
        rep = serve_async(self, list(stream), rng, growth=growth,
                          max_batch=max_batch, chunk_rounds=chunk_rounds,
                          evacuate=evacuate, compact=False, slots=1,
                          prefetch=None)
        return ServeResult(rep.results, rep.stats)
