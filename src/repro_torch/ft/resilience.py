"""Fault tolerance & straggler mitigation.

The port of ``repro.ft.resilience``'s three mechanisms:

1. **ElasticMesh** -- a mesh factory that rebuilds on a change of the
   world. Checkpoints are mesh-agnostic (``repro_torch.checkpoint`` stores
   host arrays), so a job that loses ranks restarts on the survivors: reload
   the last step, re-initialize ``torch.distributed`` over the live ranks,
   rebuild the 2-D (data, model) ``DeviceMesh`` from whatever the world now
   holds.

2. **StragglerMonitor** -- per-chunk wall-time EWMA with an outlier budget.
   A chunk that exceeds ``budget_factor`` x EWMA marks a straggler event;
   BP's response is to continue -- stale messages are *correct* under
   asynchronous BP semantics, the paper's own argument.

3. **run_bp_resilient** -- chunked BP execution on ``BPEngine.step``: run
   ``rounds_per_chunk`` at a time, checkpoint the full ``BPState``
   (messages, scheduler state, the generator's state, counters) between
   chunks, and resume from the last chunk on crash. Because ``step``
   carries the whole trajectory and the checkpoint carries the
   ``torch.Generator``'s ``get_state()`` bytes where the reference stores
   its key data, the chunked run -- and a run resumed from any of its
   checkpoints -- is bitwise the monolithic one, and a crash-restart loses
   at most one chunk of progress.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.core.engine import BPConfig, BPEngine, BPState
from repro_torch.core.graph import PGM, resolve_device

__all__ = ["ElasticMesh", "StragglerMonitor", "run_bp_resilient"]


def _world_size() -> int:
    """Ranks of the default process group; 0 when there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


class ElasticMesh:
    """Rebuilds the (data, model)-style mesh from the live world.

    ``current()`` builds a 2-D ``DeviceMesh`` over every rank of the
    initialized ``torch.distributed`` world, on ``device``'s type (the card
    by default; ``device="cpu"`` for a gloo world on the CPU): the model
    axis takes ``model_parallel`` ranks, shrunk until it divides the world,
    the data axis the rest. ``changed()`` reports whether the world size
    moved since. With no process group ``current()`` raises a
    ``RuntimeError`` naming ``torch.distributed.init_process_group``."""

    def __init__(self, model_parallel: int = 1,
                 axis_names=("data", "model"), *, device="cuda"):
        self.model_parallel = model_parallel
        self.axis_names = tuple(axis_names)
        self.device = device
        self._n = 0

    def current(self):
        dev = resolve_device(self.device)
        from repro_torch.dist import require_world
        require_world()
        from torch.distributed.device_mesh import init_device_mesh
        n = _world_size()
        mp = min(self.model_parallel, n)
        while n % mp:
            mp -= 1
        self._n = n
        return init_device_mesh(dev.type, (n // mp, mp),
                                mesh_dim_names=self.axis_names)

    def changed(self) -> bool:
        return _world_size() != self._n


@dataclasses.dataclass
class StragglerMonitor:
    budget_factor: float = 3.0
    alpha: float = 0.2
    ewma: float = 0.0
    events: int = 0
    rounds: int = 0

    def record(self, wall_s: float) -> bool:
        """Returns True if this round was a straggler."""
        self.rounds += 1
        if self.ewma == 0.0:
            self.ewma = wall_s
            return False
        straggler = wall_s > self.budget_factor * self.ewma
        if straggler:
            self.events += 1
        else:  # don't poison the EWMA with outliers
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * wall_s
        return straggler


def _whole_logm(state: BPState) -> torch.Tensor:
    """The state's whole messages (a rank-resident state's gathered: the
    same checkpoint on every rank)."""
    if getattr(state.graph, "rank_resident", False):
        return state.graph.gather(state.logm)
    return state.logm


def _own_logm(state: BPState, logm: torch.Tensor) -> torch.Tensor:
    """Restored whole messages as the state holds them (a rank-resident
    state keeps its slice)."""
    if getattr(state.graph, "rank_resident", False):
        return state.graph.local(logm)
    return logm


def _state_payload(state: BPState) -> dict:
    """Checkpointable view of a ``BPState`` (the generator's state as its
    ``get_state()`` bytes; the graph itself is not persisted -- the caller
    re-supplies it)."""
    return {"logm": _whole_logm(state), "sstate": state.sched_state,
            "rng": state.rng, "rounds": state.rounds,
            "done": state.done, "updates": state.updates,
            "hist": state.unconverged_history,
            "max_residual": state.max_residual}


def _restore_state(state: BPState, payload: dict) -> BPState:
    return dataclasses.replace(
        state, logm=_own_logm(state, payload["logm"]),
        sched_state=payload["sstate"],
        rng=payload["rng"], rounds=payload["rounds"], done=payload["done"],
        updates=payload["updates"],
        unconverged_history=payload["hist"],
        max_residual=payload["max_residual"])


def run_bp_resilient(pgm: PGM, scheduler, rng: torch.Generator, *,
                     eps: float = 1e-3, max_rounds: int = 4000,
                     rounds_per_chunk: int = 200,
                     ckpt_dir: Optional[str] = None,
                     monitor: Optional[StragglerMonitor] = None,
                     backend="ref", device="cuda"):
    """Chunked, checkpointed BP on the engine's resumable ``step`` API.

    The engine runs on ``device`` (default ``"cuda"``; with no GPU the call
    raises unless the caller passes ``device="cpu"``), through ``backend``
    (``"triton"`` launches the hand-written kernel); ``pgm`` lives there
    and ``rng`` is a ``torch.Generator`` there. Returns the same
    ``BPResult`` as a monolithic run (``rounds`` counts only rounds
    executed by *this* call, so a crash-resume of a finished run reports
    0). Resumes from ``ckpt_dir`` if it holds a newer chunk. Each chunk
    ends with a wait on the current stream (never a device-wide sync), so
    the monitor times the chunk's device work."""
    engine = BPEngine(BPConfig(scheduler=scheduler, eps=eps,
                               max_rounds=max_rounds,
                               chunk_rounds=rounds_per_chunk,
                               backend=backend), device=device)
    state = engine.init(pgm, rng)
    base_rounds = 0
    if ckpt_dir is not None and (step := latest_step(ckpt_dir)) is not None:
        try:
            payload, extra = restore_pytree(ckpt_dir, step,
                                            _state_payload(state))
            state = _restore_state(state, payload)
        except KeyError:
            # Legacy pre-engine checkpoint: only {logm, sstate} were saved.
            # Resume the messages/scheduler state; counters come from the
            # manifest and the generator restarts (the old per-chunk
            # re-seeding semantics) -- strictly better than crashing the
            # crash-recovery path on a format change.
            legacy, extra = restore_pytree(
                ckpt_dir, step,
                {"logm": _whole_logm(state), "sstate": state.sched_state})
            state = dataclasses.replace(
                state, logm=_own_logm(state, legacy["logm"]),
                sched_state=legacy["sstate"],
                rounds=torch.tensor(min(int(extra["rounds"]), max_rounds),
                                    dtype=torch.int32, device=pgm.device))
        base_rounds = int(state.rounds)
    cuda = pgm.device.type == "cuda"
    while not engine.finished(state):
        t0 = time.perf_counter()
        state = engine.step(state)
        if cuda:
            torch.cuda.current_stream(pgm.device).synchronize()
        if monitor is not None:
            monitor.record(time.perf_counter() - t0)
        if ckpt_dir is not None:
            save_pytree(ckpt_dir, int(state.rounds), _state_payload(state),
                        extra={"rounds": int(state.rounds)})
    result = engine.result(state)
    return dataclasses.replace(result, rounds=result.rounds - base_rounds)
