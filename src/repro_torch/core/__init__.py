"""Core Belief Propagation library of the port (one graph, torch).

Public API:
  BPConfig           frozen, serializable inference config (identical
                     ``to_dict`` to the reference's)
  BPEngine           init/step (chunked resume), run (one-shot)
  BPState, BPResult  resumable trajectory state, finished record
  get_scheduler      registry: "lbp"/"rbp"/"rs"/"rnbp" -> Scheduler
  Registry           the shared name->entry registry class

Building blocks:
  PGM, build_pgm, build_pgm_uniform   padded pairwise-MRF on a device
  LBP/RBP/RS/RnBP    message schedulings (Table IV)
  messages           the plain torch message math
"""

from repro_torch.core.graph import (EDGE_PAD, NEG_INF, PGM, VERTEX_PAD,
                                    build_pgm, build_pgm_uniform)
from repro_torch.core.registry import Registry
from repro_torch.core.engine import BPConfig, BPEngine, BPResult, BPState
from repro_torch.core.schedulers import (LBP, RBP, RS, RnBP, SCHEDULERS,
                                         get_scheduler, list_schedulers,
                                         register_scheduler, scheduler_spec)
from repro_torch.kernels.ops import list_backends
from repro_torch.core import messages

__all__ = [
    "PGM", "build_pgm", "build_pgm_uniform", "NEG_INF", "EDGE_PAD",
    "VERTEX_PAD", "BPConfig", "BPEngine", "BPResult", "BPState", "Registry",
    "LBP", "RBP", "RS", "RnBP", "SCHEDULERS", "get_scheduler",
    "list_schedulers", "register_scheduler", "scheduler_spec",
    "list_backends", "messages",
]
