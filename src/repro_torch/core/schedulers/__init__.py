"""Message schedulings studied in the paper (Table IV).

| Algorithm  | Frontier selection              | Module     | Spec      |
|------------|---------------------------------|------------|-----------|
| LBP        | all messages                    | lbp.py     | "lbp"     |
| RBP        | sort-and-select top-k (edges)   | rbp.py     | "rbp"     |
| RS         | top-k vertices + depth-h splash | rs.py      | "rs"      |
| RnBP       | eps-filter + randomized p       | rnbp.py    | "rnbp"    | (paper's contribution)
| RLX        | per-queue top-k, sampled queues | rlx.py     | "rlx"     |
| RLXTree    | rlx with dst-ordered queues     | rlxtree.py | "rlxtree" |

The port of ``repro.core.schedulers``. Schedulers are addressable by string
spec through a :class:`repro_torch.core.registry.Registry` with the
reference's names, so ``BPConfig`` serializes identically in both packages.
Serial RBP (the paper's SRBP baseline) lives in ``repro_torch.core.serial``
as host-side numpy; it is not a ``Scheduler`` (it owns its own loop) and is
reached via ``BPConfig(scheduler="srbp")`` instead of this registry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Type

from repro_torch.core.registry import Registry
from repro_torch.core.schedulers.base import Scheduler
from repro_torch.core.schedulers.lbp import LBP
from repro_torch.core.schedulers.rbp import RBP
from repro_torch.core.schedulers.rlx import RLX
from repro_torch.core.schedulers.rlxtree import RLXTree
from repro_torch.core.schedulers.rnbp import RnBP
from repro_torch.core.schedulers.rs import RS

#: name -> Scheduler class. Names are the canonical serialized form.
SCHEDULERS: Registry[Type] = Registry("scheduler", {
    "lbp": LBP,
    "rbp": RBP,
    "rs": RS,
    "rnbp": RnBP,
    "rlx": RLX,
    "rlxtree": RLXTree,
})


def register_scheduler(name: str, *,
                       overwrite: bool = False) -> Callable[[Type], Type]:
    """Class decorator registering a scheduler under ``name`` (lowercased).
    Duplicate names raise ``ValueError`` unless ``overwrite=True``."""
    return SCHEDULERS.register(name, overwrite=overwrite)


def list_schedulers() -> List[str]:
    """Sorted registered scheduler names (the valid ``BPConfig.scheduler``
    string specs)."""
    return SCHEDULERS.names()


def get_scheduler(spec, **kwargs) -> Scheduler:
    """Resolve a scheduler spec: a registry name (+ constructor kwargs) or an
    already-built ``Scheduler`` instance (kwargs must then be empty)."""
    if isinstance(spec, str):
        if spec.lower() == "srbp":
            raise ValueError(
                "'srbp' is the host-serial baseline, not a frontier "
                "scheduler; use BPEngine(BPConfig(scheduler='srbp')).run()")
        return SCHEDULERS.lookup(spec)(**kwargs)
    if kwargs:
        raise ValueError("scheduler kwargs only apply to string specs, got "
                         f"instance {type(spec).__name__} plus {kwargs}")
    return spec


def scheduler_spec(sched: Scheduler):
    """Inverse of ``get_scheduler`` for registered types:
    ``(name, kwargs_dict)``. Raises KeyError for unregistered classes."""
    for name, cls in SCHEDULERS.items():
        if type(sched) is cls:
            return name, dataclasses.asdict(sched)
    raise KeyError(f"{type(sched).__name__} is not a registered scheduler")


__all__ = ["Scheduler", "LBP", "RBP", "RS", "RnBP", "RLX", "RLXTree",
           "SCHEDULERS", "get_scheduler", "register_scheduler",
           "list_schedulers", "scheduler_spec"]
