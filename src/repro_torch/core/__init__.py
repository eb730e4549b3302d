"""Core Belief Propagation library of the port (torch).

Public API:
  BPConfig           frozen, serializable inference config (identical
                     ``to_dict`` to the reference's)
  BPEngine           init/step (chunked resume), run/run_many (one-shot),
                     load_slot (refill one slot of a bucket), serve (the
                     evacuating bucketed serving loop)
  BPState, BPResult  resumable trajectory state, finished record
  ServeResult/ServeStats   serving output + sweep accounting
  serve_async        asynchronous serving pipeline (``core.serving``):
                     online request iterators, resident bucket slots,
                     staging copies ahead of admission, bucket compaction,
                     pluggable admission, threaded ingestion
  ServingPipeline    the pipeline behind serve_async (generator API)
  AdmissionPolicy    admission-policy base + registry (fifo/residual/
                     windowed/deadline via get_admission_policy);
                     DeadlineAdmission is the SLA tier (SweepClock for
                     virtual time)
  get_scheduler      registry: "lbp"/"rbp"/"rs"/"rnbp"/"rlx"/"rlxtree"
                     -> Scheduler
  Registry           the shared name->entry registry class

Building blocks:
  PGM, build_pgm, build_pgm_uniform, pad_pgm   padded pairwise-MRF on a
                     device
  BatchedPGM, bucket_pgms   padded buckets of graphs; RidgeEffort and
                     RoundsHistory (rounds predictors)
  LBP/RBP/RS/RnBP    message schedulings (Table IV)
  RLX/RLXTree        relaxed multi-queue priority family (2002.11505)
  messages           the plain torch message math
"""

from repro_torch.core.graph import (EDGE_PAD, NEG_INF, PGM, VERTEX_PAD,
                                    build_pgm, build_pgm_uniform, pad_pgm)
from repro_torch.core.batch import (BatchedPGM, Bucket, RidgeEffort,
                                    RoundsHistory, batch_generators,
                                    bucket_key, bucket_pgms, bucket_shape,
                                    group_ceilings, slot_generator,
                                    slot_seed)
from repro_torch.core.registry import Registry
from repro_torch.core.engine import (BPConfig, BPEngine, BPResult, BPState,
                                     ServeResult, ServeStats)
from repro_torch.core.serving import (ADMISSION_POLICIES, AdmissionPolicy,
                                      AsyncServeResult, AsyncServeStats,
                                      DeadlineAdmission, FIFOAdmission,
                                      RequestRecord, ResidualAdmission,
                                      ServingPipeline, SweepClock,
                                      WindowedAdmission,
                                      get_admission_policy,
                                      list_admission_policies,
                                      register_admission_policy, serve_async)
from repro_torch.core.schedulers import (LBP, RBP, RLX, RLXTree, RS, RnBP,
                                         SCHEDULERS, get_scheduler,
                                         list_schedulers, register_scheduler,
                                         scheduler_spec)
from repro_torch.kernels.ops import list_backends
from repro_torch.core import messages

__all__ = [
    "PGM", "build_pgm", "build_pgm_uniform", "pad_pgm", "NEG_INF", "EDGE_PAD",
    "VERTEX_PAD", "BatchedPGM", "Bucket", "RidgeEffort", "RoundsHistory",
    "batch_generators", "bucket_key", "bucket_pgms", "bucket_shape",
    "group_ceilings", "slot_generator", "slot_seed", "BPConfig", "BPEngine",
    "BPResult", "BPState", "ServeResult", "ServeStats",
    "AsyncServeResult", "AsyncServeStats", "RequestRecord",
    "ServingPipeline", "serve_async",
    "ADMISSION_POLICIES", "AdmissionPolicy", "DeadlineAdmission",
    "FIFOAdmission", "ResidualAdmission", "SweepClock",
    "WindowedAdmission", "get_admission_policy",
    "register_admission_policy", "list_admission_policies", "Registry",
    "LBP", "RBP", "RS", "RnBP", "RLX", "RLXTree", "SCHEDULERS",
    "get_scheduler", "list_schedulers", "register_scheduler",
    "scheduler_spec", "list_backends", "messages",
]
