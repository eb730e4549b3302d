"""Deprecated entry points for frontier-based BP: ``run_bp`` (one graph),
``run_bp_batch`` (one bucket) and ``run_bp_many`` (a graph list).

The port of ``repro.core.runner`` and of the two wrappers that the
reference keeps in ``repro.core.batch``. The loop (paper Algorithm 1)
lives in ``repro_torch.core.engine``; these are thin wrappers that build a
``BPEngine`` on the graph's device and emit the reference's
``DeprecationWarning``. New code should use::

    engine = BPEngine(BPConfig(scheduler="rnbp", eps=1e-3, max_rounds=2000),
                      device="cuda")
    res = engine.run(pgm, generator)

and, for resumable execution, ``engine.init`` / ``engine.step`` instead of
the old ``_init_logm``/``_init_state`` backdoor (still honored here for
callers that carried state manually).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Sequence

from repro_torch.core import messages as M
from repro_torch.core.batch import BatchedPGM
from repro_torch.core.engine import BPConfig, BPEngine, BPResult
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers.base import Scheduler

__all__ = ["run_bp", "run_bp_batch", "run_bp_many"]


def run_bp(pgm: PGM,
           scheduler: Scheduler,
           rng,
           *,
           eps: float = 1e-3,
           max_rounds: int = 2000,
           damping: float = 0.0,
           update_fn: Callable = M.ref_update,
           track_history: bool = True,
           _init_logm=None,
           _init_state: Any = None) -> BPResult:
    """Deprecated wrapper: ``BPEngine(BPConfig(...)).run(pgm, rng)`` on the
    graph's device (``rng`` a ``torch.Generator`` there)."""
    warnings.warn(
        "run_bp is deprecated: use repro_torch.core.BPEngine with a "
        "BPConfig (config-driven scheduler/backend, chunked resume via "
        "init/step)", DeprecationWarning, stacklevel=2)
    engine = BPEngine(BPConfig(
        scheduler=scheduler, eps=eps, max_rounds=max_rounds, damping=damping,
        backend=update_fn, history=track_history), device=pgm.device)
    state = engine.init(pgm, rng)
    if _init_logm is not None:
        state = dataclasses.replace(state, logm=_init_logm)
    if _init_state is not None:
        state = dataclasses.replace(state, sched_state=_init_state)
    return engine.run(pgm, state=state)


def _deprecated(name: str) -> None:
    warnings.warn(
        f"{name} is deprecated: use repro_torch.core.BPEngine with a "
        "BPConfig (config-driven scheduler/backend, chunked resume, "
        "evacuation)", DeprecationWarning, stacklevel=3)


def run_bp_batch(batch: BatchedPGM,
                 scheduler: Scheduler,
                 rng,
                 *,
                 eps: float = 1e-3,
                 max_rounds: int = 2000,
                 damping: float = 0.0,
                 update_fn: Callable | None = None,
                 batch_update_fn: Callable | None = None,
                 track_history: bool = False) -> BPResult:
    """Deprecated wrapper: ``BPEngine(BPConfig(...)).run(batch, rng)`` on
    the bucket's device. Returns a ``BPResult`` whose every field carries a
    leading batch axis, each slice equal to the graph's solo run."""
    _deprecated("run_bp_batch")
    cfg = BPConfig(scheduler=scheduler, eps=eps, max_rounds=max_rounds,
                   damping=damping,
                   backend=update_fn if update_fn is not None else "ref",
                   batch_backend=batch_update_fn, history=track_history)
    return BPEngine(cfg, device=batch.device).run(batch, rng)


def run_bp_many(pgms: Sequence[PGM],
                scheduler: Scheduler,
                rng,
                *,
                growth: float = 2.0,
                max_batch: int | None = None,
                **bp_kwargs: Any):
    """Deprecated wrapper: ``BPEngine(BPConfig(...)).run_many(pgms, rng)``
    on the graphs' device (or ``.serve(...)`` for the evacuating path).
    Graph ``i`` draws from ``slot_generator(base, i)``, independent of
    bucketing."""
    _deprecated("run_bp_many")
    cfg = BPConfig(scheduler=scheduler,
                   eps=bp_kwargs.pop("eps", 1e-3),
                   max_rounds=bp_kwargs.pop("max_rounds", 2000),
                   damping=bp_kwargs.pop("damping", 0.0),
                   backend=bp_kwargs.pop("update_fn", None) or "ref",
                   batch_backend=bp_kwargs.pop("batch_update_fn", None),
                   history=bp_kwargs.pop("track_history", False))
    if bp_kwargs:
        raise TypeError(f"unknown arguments: {sorted(bp_kwargs)}")
    if not pgms:
        return []
    return BPEngine(cfg, device=pgms[0].device).run_many(
        pgms, rng, growth=growth, max_batch=max_batch)
