"""Resumable BP engine on one graph: config-driven entry, chunked stepping.

The port of ``repro.core.engine``'s single-graph path. The scheduling
policy (LBP/RBP/RS/RnBP) and everything else is one frozen, serializable
``BPConfig`` behind one inference loop:

    engine = BPEngine(BPConfig(scheduler="rnbp",
                               scheduler_kwargs={"low_p": 0.4},
                               eps=1e-3, max_rounds=2000), device="cuda")
    res = engine.run(pgm, torch.Generator("cuda").manual_seed(0))

Chunked resume:

    state = engine.init(pgm, generator)     # BPState: every carried tensor
    while not engine.finished(state):
        state = engine.step(state)          # one chunk of <= chunk_rounds
    res = engine.result(state)

``step`` carries the *entire* trajectory (messages, scheduler state, the
generator's state, round/update counters, history), so N rounds through
repeated ``step`` are bitwise N rounds in one ``run``.

The reference runs a chunk as one ``lax.while_loop`` with ``done`` on the
device. Here the loop is Python over device tensors: counters stay on the
device, every round's effects are gated on a device-side ``active`` flag
(as the reference's batched ``_chunk_batch`` gates each graph), and the
host reads ``done`` once per chunk start and then once every
``SYNC_ROUNDS`` rounds. Rounds run after convergence inside a window are
inert: they commit nothing and advance no counter. A window never runs
past the chunk's round limit, so every chunk boundary sees exactly the
generator state a monolithic run has there.

``BPConfig`` keeps every field of the reference, serving-only ones
(``admission``, ``admission_kwargs``) included, so ``to_dict`` output is
identical across the two packages. Batched buckets and the host-serial
``"srbp"`` baseline are not ported yet (ROADMAP queue 1, items 8 and 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core import messages as M
from repro_torch.core.graph import PGM, resolve_device
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.schedulers.base import Scheduler

__all__ = ["BPConfig", "BPEngine", "BPResult", "BPState", "SYNC_ROUNDS"]

#: rounds between host reads of ``done`` inside a chunk
SYNC_ROUNDS = 16


# --------------------------------------------------------------- results --

@dataclasses.dataclass(frozen=True)
class BPResult:
    """Finished-trajectory record returned by ``BPEngine.run``/``result``.

    ``converged`` is True iff every real edge's residual fell below the
    config's ``eps`` within ``max_rounds`` sweeps; ``beliefs`` are valid
    either way (the best marginals at exit). Counters are 0-d tensors on
    the graph's device.
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
    "triton", through ``repro_torch.kernels.ops.UPDATE_BACKENDS``) or is a
    ``(pgm, logm) -> (cand, resid)`` callable. ``chunk_rounds`` bounds
    rounds per ``step`` (None = to ``max_rounds`` in one chunk);
    ``history`` sizes the per-round unconverged-count buffer.
    ``batch_backend``, ``admission`` and ``admission_kwargs`` belong to the
    batched and serving paths, which the port does not have yet; they ride
    the config for interchange only.
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

    Counters are 0-d tensors on the graph's device; ``rng`` is the state of
    the run's ``torch.Generator`` (``Generator.get_state()``), so a resumed
    state draws exactly what an uninterrupted run would. ``chunk_iters`` is
    bookkeeping (active rounds of the last ``step``), not trajectory.
    """

    graph: PGM
    logm: torch.Tensor          # (E, S) current messages
    sched_state: Any            # scheduler carry
    rng: torch.Tensor           # generator state (uint8, on the host)
    rounds: torch.Tensor        # () int32 cumulative rounds
    done: torch.Tensor          # () bool convergence
    updates: torch.Tensor       # () int64 committed messages
    unconverged_history: torch.Tensor  # (H,) int32
    max_residual: torch.Tensor  # () f32
    chunk_iters: torch.Tensor   # () int32, diagnostics only

    def messages_numpy(self) -> np.ndarray:
        """The current (E, S) messages as a host numpy array -- with
        ``BPEngine.init(..., logm=...)`` the bridge that resumes one
        package's trajectory in the other."""
        return self.logm.cpu().numpy()


def _where_tree(active: torch.Tensor, new, old):
    if isinstance(new, torch.Tensor):
        return torch.where(active, new, old)
    return new          # () carries: nothing to gate


# ---------------------------------------------------------------- engine --

class BPEngine:
    """The BP inference engine on one graph (see module docstring).

    One engine = one resolved (scheduler, backend) pair on one device.
    ``device`` defaults to ``"cuda"``; with no GPU the constructor raises
    unless the caller passes ``device="cpu"``.
    """

    def __init__(self, config: BPConfig | None = None, *, device="cuda",
                 **overrides):
        config = config or BPConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = resolve_device(device)
        if isinstance(config.scheduler, str) and \
                config.scheduler.lower() == "srbp":
            raise NotImplementedError(
                "scheduler='srbp' (the host-serial baseline) is not ported "
                "to repro_torch yet: ROADMAP queue 1, item 6")
        if config.batch_backend is not None:
            raise NotImplementedError(
                "batch_backend belongs to the batched path, not ported to "
                "repro_torch yet: ROADMAP queue 1, item 8")
        self.scheduler: Scheduler = config.make_scheduler()
        self.update_fn = self._resolve_backend(config.backend)

    @staticmethod
    def _resolve_backend(backend) -> Callable:
        if callable(backend):
            return backend
        from repro_torch.kernels.ops import get_update_fn
        return get_update_fn(backend)

    def _check_graph(self, graph) -> PGM:
        if not isinstance(graph, PGM):
            raise NotImplementedError(
                f"repro_torch's BPEngine runs one PGM, got "
                f"{type(graph).__name__}; batched buckets (BatchedPGM) are "
                "ROADMAP queue 1, item 8")
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

    # -- lifecycle ---------------------------------------------------------

    def init(self, graph: PGM, rng, *, logm=None) -> BPState:
        """Fresh trajectory state for ``graph``. ``rng`` is a
        ``torch.Generator`` on the graph's device; its state is copied, not
        advanced. ``logm`` optionally replaces the uniform
        initial messages ((E, S) numpy array or tensor), e.g. to resume a
        trajectory that the reference package started."""
        pgm = self._check_graph(graph)
        dev = pgm.device
        gen = self._check_generator(rng, dev)
        if logm is None:
            logm = M.init_messages(pgm)
        else:
            if not isinstance(logm, torch.Tensor):
                logm = torch.tensor(np.asarray(logm))      # a copy
            logm = logm.to(device=dev, dtype=torch.float32).contiguous()
            shape = (pgm.n_edges, pgm.n_states_max)
            if tuple(logm.shape) != shape:
                raise ValueError(f"logm must be {shape}, got "
                                 f"{tuple(logm.shape)}")
        hist_len = self.config.max_rounds if self.config.history else 1
        return BPState(
            graph=pgm, logm=logm, sched_state=self.scheduler.init(pgm),
            rng=gen.get_state().clone(),
            rounds=torch.zeros((), dtype=torch.int32, device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            updates=torch.zeros((), dtype=torch.int64, device=dev),
            unconverged_history=torch.full((hist_len,), -1, dtype=torch.int32,
                                           device=dev),
            max_residual=torch.full((), float("inf"), dtype=torch.float32,
                                    device=dev),
            chunk_iters=torch.zeros((), dtype=torch.int32, device=dev))

    def step(self, state: BPState, *,
             chunk_rounds: int | None = None) -> BPState:
        """Advance one chunk: at most ``chunk_rounds`` further rounds,
        stopping early on convergence. A finished state is a no-op.
        Bitwise equal to running the same total rounds in one chunk."""
        cfg, sched = self.config, self.scheduler
        pgm = self._check_graph(state.graph)
        chunk = chunk_rounds or cfg.chunk_rounds or cfg.max_rounds
        rounds0, done0 = int(state.rounds), bool(state.done)   # host reads
        limit = min(rounds0 + chunk, cfg.max_rounds)
        if done0 or rounds0 >= limit:
            return dataclasses.replace(state, chunk_iters=torch.zeros_like(
                state.chunk_iters))
        inner = sched.inner_sweeps
        n_iters = -(-(limit - rounds0) // inner)     # rounds < limit, exact
        gen = torch.Generator(device=pgm.device)
        gen.set_state(state.rng)

        logm, sstate = state.logm, state.sched_state
        rounds, done, updates = state.rounds, state.done, state.updates
        hist, max_r = state.unconverged_history, state.max_residual
        iters = torch.zeros_like(state.chunk_iters)
        hist_last = hist.shape[0] - 1
        for it in range(n_iters):
            active = ~done
            cand, r = self.update_fn(pgm, logm)
            unconverged = ((r >= cfg.eps) & pgm.edge_mask).sum().to(
                torch.int32)
            frontier, new_sstate = sched.select(pgm, r, cfg.eps, gen, sstate,
                                                unconverged)
            sstate = _where_tree(active, new_sstate, sstate)
            # Converged -> commit nothing (IsConverged precedes Update).
            newly_done = (unconverged == 0) & active
            frontier = frontier & active & ~newly_done
            logm = M.apply_frontier(logm, cand, frontier, cfg.damping)
            for _ in range(inner - 1):     # Residual Splash's extra sweeps
                cand, _ = self.update_fn(pgm, logm)
                logm = M.apply_frontier(logm, cand, frontier, cfg.damping)
            updates = updates + frontier.sum() * inner
            if cfg.history:
                idx = torch.clamp(rounds, max=hist_last).long().reshape(1)
                hist = hist.scatter(0, idx, torch.where(
                    active, unconverged, hist.gather(0, idx)[0]).reshape(1))
            rounds = rounds + torch.where(
                newly_done | ~active, 0, inner).to(torch.int32)
            max_r = torch.where(active, r.amax(), max_r)
            iters = iters + active.to(torch.int32)
            done = done | newly_done
            if (it + 1) % SYNC_ROUNDS == 0 and it + 1 < n_iters and bool(done):
                break
        return dataclasses.replace(
            state, logm=logm, sched_state=sstate, rng=gen.get_state(),
            rounds=rounds, done=done, updates=updates,
            unconverged_history=hist, max_residual=max_r, chunk_iters=iters)

    def finished(self, state: BPState) -> bool:
        """True when the graph converged or exhausted ``max_rounds``."""
        return bool(state.done) or int(state.rounds) >= self.config.max_rounds

    def result(self, state: BPState) -> BPResult:
        """Finalize a state into a ``BPResult`` (computes beliefs)."""
        return BPResult(beliefs=M.beliefs(state.graph, state.logm),
                        logm=state.logm, rounds=state.rounds,
                        updates=state.updates, converged=state.done,
                        max_residual=state.max_residual,
                        unconverged_history=state.unconverged_history,
                        sched_state=state.sched_state)

    # -- one-shot ----------------------------------------------------------

    def run(self, graph: PGM, rng=None, *,
            state: BPState | None = None) -> BPResult:
        """One-shot inference, chunk by chunk when ``chunk_rounds`` is set
        (same trajectory either way). ``state`` resumes an existing
        trajectory instead of starting fresh."""
        if state is None:
            if rng is None:
                raise ValueError("run() needs an rng (a torch.Generator) or "
                                 "a state")
            state = self.init(graph, rng)
        while not self.finished(state):
            state = self.step(state)
        return self.result(state)
