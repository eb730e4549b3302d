#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout with ``nvcc``, holds each
kernel against its plain torch version on the card, drives the port's two
main paths and its serving path at full size and measures them:

- one graph: one RnBP inference on a 1000 x 1000 Ising grid (3,996,032
  directed edges) through ``BPEngine(backend="triton")``, then the
  paper-size runs, the max-product (MAP) path, a card-vs-CPU agreement
  check, kernel timings (CUDA events) and a ``torch.profiler`` trace of
  main-path rounds (device time by kernel, busy share);
- many graphs: ``BPEngine.run_many`` over four 384 x 288 stereo frames at
  16 disparities (the Middlebury "Tsukuba" pair's size; one bucket of
  1,764,352 directed edges) through the ``"pallas"`` backends, whose
  kernel is ``fused_update_t``; slot 0 against its solo run; the zoo
  stream through both bucket paths against the CPU's plain path; then the
  same timings and trace for a batched round, and the edge-prelude kernel
  bitwise ``messages.edge_prelude`` and timed at a frame, the bucket's
  union and the Ising grid (``phase_prelude``);
- serving: ``serve_async`` over an online stream of eight stereo frames
  of the same size interleaved with the zoo stream (two resident
  buckets, staging copies ahead of admission, compaction, two feeder
  threads); two stereo requests against their padded solo runs,
  ``engine.serve`` against ``run_many``, the cost of one backfill at the
  stereo shape, and the deadline policy under a ``SweepClock`` on the card
  against the CPU's plain path (phase 14);
- the router tier: the same stream through ``serve_routed`` with two
  replicas, each a pipeline on its own thread and its own CUDA stream:
  traced (busy seconds, the streams the kernels ran on, the replicas'
  overlap), round robin bitwise each share's solo run, least-loaded with
  stealing bitwise round robin, the deadline policy routed on card and
  CPU, and the skewed-stealing scenario (phase 15);
- resilient runs and the serial baseline: ``run_bp_resilient`` on the
  one-graph main path, chunked and resumed from a checkpoint, bitwise the
  engine run; SRBP on the paper's Ising 200 x 200 beside RnBP on the card;
  a chain's RnBP beliefs against variable elimination (phase 16);
- the multi-device paths (``repro_torch.dist``, each rank holding only its
  slice of the messages and pairwise tables; the host has one card):
  (a) a world of one rank over NCCL, ``run_bp_sharded`` on the one-graph
  main path bitwise phase 4's run and banded LBP at n = 1 bitwise a
  one-device LBP run, with the collectives' device time (CUDA events);
  (b) two gloo ranks in spawned processes sharing the card, their
  exchanges staged through the host: sharded LBP and RnBP on the paper's
  Ising 200 x 200 bitwise one-device runs, banded LBP bitwise; (c) on the
  same ranks, phase 10's four stereo frames (built on the host, only each
  rank's slice copied to the card) through ``run_many``, bitwise a
  one-device ``run_many``, with each rank's bytes of graph and messages
  against one device's, peak memory, ms/round and staged bytes; every
  rank's messages bitwise equal (phase 17);
- the LM stack's serving path (``repro_torch.models``,
  ``repro_torch.launch.serve``), which runs none of the BP kernels: every
  family at ``reduced()`` on the card against the CPU (prefill logits and
  caches, 8 decode steps, MoE routing equal, host syncs of a decode step);
  Qwen3-4B's full width at two layers in float32 against the CPU over
  1,024 tokens; Qwen3-4B as published (36 layers, bf16, weights drawn on
  the card) served at B = 4: prefill over 1,024 tokens, ``generate`` with
  a 64-token prompt and 32 new tokens (decode ms/step beside the bytes
  bound, decode against prefill within 3e-2), a profiler trace of 8
  decode steps (phase 18);
- the LM stack's training path (``repro_torch.train``, ``repro_torch.data``),
  which runs none of the BP kernels either: every family at ``reduced()``
  on the card against the CPU (``forward_train``'s metrics, every gradient
  leaf, one AdamW update), a step with remat bitwise one without, two
  microbatches against one, a run checkpointed and resumed bitwise the
  unbroken one, host syncs of a train step; Qwen3-4B's widths at two
  layers in float32 against the CPU (loss and gradients, S = 512); and
  Qwen3-4B as published (36 layers, bf16 compute over float32 masters)
  trained 10 steps at B = 1, S = 2,048: ms/step, tokens/s, model FLOPs and
  their share of the card's dense bf16 peak (``mfu``), peak memory, a
  profiler trace of two steps, the loss falling (phase 19);
- the LM stack's sharded serving path (``repro_torch.launch.sharding``,
  tensor-parallel prefill and decode over a ("data", "model") mesh), which
  runs none of the BP kernels: the ten families at ``reduced()`` over
  "model" on a world of one over NCCL, bitwise one device, and on two gloo
  ranks sharing the card (meshes (1, 2) and (2, 1)) within 1e-4, ranks
  bitwise equal, cache blocks the slices of the one-device caches;
  Granite-MoE 3B-a800m as published (32
  layers, bf16) served at B = 4 on one device (prefill over 1,024 tokens,
  ``generate`` 64 + 32 with decode ms/step beside the bytes bound, host
  syncs of a decode step), its prefill on a world of one bitwise, and
  decode against prefill at full depth within 1e-4 in float32 (in bf16
  reported with its routing flips); then over the two gloo ranks with the
  "sharded" dispatch at full depth: float32 with one device's routing
  pinned within 1e-4 of one device, bf16 pinned and as it routes
  reported, with each rank's parameter bytes, decode ms/step, collectives
  and staged bytes per step (phase 20);
- the LM stack's sharded training path (tensor-parallel and ZeRO-3 train
  steps over ``torch.distributed``, gradients through the collectives),
  which runs none of the BP kernels: the CPU tests' cases -- the ten
  families tensor-parallel at ``reduced()``, every family under "fsdp"
  widened so ZeRO-3 shards its leaves -- 3 steps on a world of one over
  NCCL, bitwise one device's (metrics, step 0's gradients, masters and
  moments), and on two gloo ranks sharing the card within 1e-4 of one
  device, ranks bitwise; Granite's published widths at two layers in
  float32 over the ranks within 1e-4 of one device; Granite-MoE 3B-a800m
  as published trained 5 steps over the ranks at (1, 2): ms/step,
  tokens/s, collectives and bytes staged per step, state bytes and peak
  per rank, the loss over batches 0..2 before and after (phase 21);
- tensor parallelism of the SSM, hybrid, MLA and encoder-decoder blocks
  over two gloo ranks sharing the card at (1, 2), no BP kernel: Mamba2-130M
  as published (24 layers) in float32, prefill over 1,024 tokens and 32
  decode steps within 1e-4 of one device and 3 train steps within 1e-5
  (metrics) and 1e-4 (leaves), a world of one over NCCL bitwise one
  device; in bf16 served (prefill tokens/s, decode ms/step by CUDA events
  beside the bytes bound, collectives and staged bytes per step) and
  trained 5 steps over float32 masters (ms/step, tokens/s, state and peak
  per rank, the eval loss falling); then Hymba-1.5B's, DeepSeek-V3's (MLA,
  MTP) and Whisper-medium's published widths at two layers in float32:
  prefill over 256 tokens, 16 decode steps and step 0's gradients within
  1e-4 of one device, ranks bitwise (phase 22);
- serving over sub-meshes (``repro_torch.dist.make_bp_mesh(ranks=...)``,
  the sharded pipeline's leader deciding for its group, the router's
  front and remote leaders): four gloo ranks sharing the card in two
  sub-meshes of two, phase 14's stream cut to four Tsukuba frames and
  ``zoo_stream(12)`` at its config on ``"sharded"``. Rank 0 first serves
  it on one device through ``"triton"`` as the yardstick; (a)
  ``serve_async`` on one sub-mesh under ``windowed`` admission on the wall
  clock with two ingest threads, both ranks' records the same and bitwise
  the yardstick's, two decision broadcasts a cycle; (b) ``serve_routed``
  over both: round robin bitwise the yardstick, each share bitwise its
  solo sharded run, and ``least_loaded`` with stealing on phase 15's
  skewed stream (a steal at least) bitwise a one-device run; requests/s,
  latency, collectives, staged bytes, decisions per cycle and each rank's
  peak; ``fused_update_e`` against its plain version on every served
  slice shape (phase 23);
- the cost counters (``roofline.op_cost``, ``kernel_model.round_cost``,
  ``launch.dryrun``): one engine round of phase 10's stereo bucket counted
  through the kernels' dispatcher ops under ``"triton"``, ``"pallas"`` and
  ``"triton"`` at ``semiring="max"``, each kernel against its plain
  version and its counted bytes exactly ``fused_update_cost``'s, the
  round's bytes over phase 12's ms a round as a share of the memory rate;
  Qwen3-4B's train step at B = 1, S = 2,048 counted on fake tensors, its
  flops beside ``model_flops`` and its predicted peak within 2x of phase
  19's measured one; ``launch.dryrun`` of Qwen3-4B and Mamba2-130M at
  ``decode_32k`` on the (16, 16) mesh of a fake world (both counts in
  subprocesses started after the build, beside phases 3-23: they take no
  card); the host's cost of a call through a dispatcher op (phase 24);
- the entry points (``repro_torch.examples``): each driver's ``main`` as
  a user calls it, on the card, with the reference's acceptances --
  ``quickstart`` as published (LBP stalls, RBP and RnBP converge),
  ``stereo_bp`` at the Tsukuba size (accuracy over the observation's,
  energy under the truth's, labels bitwise the plain max-product path's),
  ``ldpc_decode`` at its defaults (coded BER under uncoded),
  ``bp_serving``'s async pipeline and its router with stealing over
  ``zoo_stream(36)`` (every request converged; requests/s, latency),
  ``train_lm`` (resume drift exactly 0), and ``distributed_bp`` inside
  phase 17's two gloo ranks (sharded bitwise one device, banded round
  parity); each kernel's launches per driver (phase 25);
- the docs' executable spec: every page of ``docs/torch/`` as a reader
  runs it with ``DEVICE = "cuda"`` (``sharding.md`` on an NCCL world of
  one), each page's own asserts holding -- ``kernels.md``'s holds
  ``fused_update_e`` against its plain version, sum within 1e-4 and max
  bitwise -- and README's first port block at its full size; seconds and
  launches per page (phase 26).

Both kernels are held against their plain versions at every state count
on a boundary of their launch plans (phases 3 and 9, with the first edges
launched alone against the full launch, bitwise) and on the buckets' own
operands (phase 12); both are timed at every measured shape (the one-graph
S = 2 path, the protein MRF, the stereo bucket, the zoo's widest bucket;
phases 7 and 12).

Every phase raises on failure; nothing is caught. Output:

- progress lines per phase, the kernels' ``-Xptxas -v`` lines first;
- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"docs": ...}``: phase 26's blocks, seconds per page
  and launches per kernel;
- one JSON line ``{"kernels": [...]}``: per kernel its launches on its path
  and on each of the sixteen paths (``launches_by_path``), its largest
  difference from the plain version, its time, the plain
  version's time and the least time the card could take (``bound_ms``) at
  the main path's shape, and ``shapes``, the same per measured shape;
  the edge-prelude kernel's entry last (``prelude_by_path``: on every
  path whose updates run through a kernel backend it launched once per
  fused update, ``check_prelude_launches``);
- last, ``{"ok": true, "device": {"platform": "gpu", ...}}``.

A fuller report goes to ``chiprun_out/chip_smoke_report.json``. The script
needs one GPU, imports nothing of JAX or of the JAX package ``repro``, and
exits non-zero without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

NEG_INF = -1.0e30
SUM_TOL = 1e-4                       # sum-product: kernel vs plain, absolute
MAIN_N, MAIN_C = 1000, 2.5           # the main path's Ising grid
MAIN_KW = {"low_p": 0.4, "high_p": 0.9}   # the main path's RnBP
PAPER_N = 200                        # the paper's Ising benchmark size
CPU_N, CPU_C = 100, 2.0              # card-vs-CPU agreement graph
# S on both sides of every boundary of the kernels' launch plans
CHECK_STATES = (1, 2, 3, 8, 9, 15, 16, 17, 31, 32, 33, 51, 64, 81, 127, 128)
CHECK_EDGES = (1, 127, 4096, 3_996_032)
SUB_EDGES = 37                       # the sub-launch check's first edges
CHECK_TABLE_BYTES = 1 << 30          # cap E so one (E, S, S) table <= 1 GiB

REPLACES = {"sum": "src/repro/kernels/triton_update.py:103",
            "max": "src/repro/kernels/triton_update.py:125"}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_update_e.cu"

# The batched main path: four stereo frames at the Middlebury "Tsukuba"
# pair's size (384 x 288, 16 disparity levels) in one bucket, RnBP.
STEREO = {"height": 288, "width": 384, "n_disp": 16}
STEREO_FRAMES, STEREO_ROUNDS = 4, 1000
ZOO_N, ZOO_EPS, ZOO_ROUNDS = 36, 1e-4, 2000    # the zoo stream, LBP
CHECK_T_STATES = CHECK_STATES + (200, 300)   # 300: the walk variant
CHECK_T_EDGES = (1, 127, 4096, 1_764_352)
T_SOURCE = "src/repro_torch/kernels/csrc/fused_update_t.cu"
T_REPLACES = "src/repro/kernels/message_update.py:59"
PRELUDE_SOURCE = "src/repro_torch/kernels/csrc/edge_prelude.cu"
# no Pallas kernel: the reference's prelude is plain jnp
PRELUDE_REPLACES = "src/repro/core/messages.py edge_prelude (plain jnp)"
RESULT_FIELDS = ("logm", "beliefs", "rounds", "updates", "converged",
                 "max_residual", "unconverged_history", "sched_state")
# The serving path: stereo frames at the Tsukuba size interleaved with the
# zoo stream, online, through serve_async.
SERVE_FRAMES, SERVE_ZOO = 8, 36
SERVE_KW = dict(max_batch=4, slots=2, prefetch=8, compact=True,
                ingest_threads=2)
# The deadline check: LBP on the zoo stream under a SweepClock, with latency
# budgets (virtual seconds) that evict requests mid-flight.
DEADLINE_EPS, DEADLINE_CHUNK = 1e-4, 16
DEADLINE_SLOS = {"ising": 100.0, "chain": 200.0}
# The router tier: the serving path's stream through two replicas on the
# card, each at the serving path's knobs (a replica always has one feeder).
ROUTER_REPLICAS = 2
ROUTER_KW = dict(max_batch=4, slots=2, prefetch=8, compact=True)
# The router's SLA check: the zoo stream without budgets plus two 6 x 6
# Ising grids that never converge at DEADLINE_EPS, with budgets far under
# ZOO_ROUNDS: evicted whatever the replicas' interleaving.
ROUTER_SLO, ROUTER_IMPOSSIBLE = 40.0, (0, 2)
# The skewed-stealing scenario of benchmarks/bench_router.py, at its knobs.
SKEW_EPS, SKEW_ROUNDS, SKEW_FAST, SKEW_HOLD_S = 1e-5, 480, 30, 2.0
SKEW_KW = dict(max_batch=2, chunk_rounds=16, slots=1, prefetch=2,
               ingest_queue=1, admission="windowed",
               admission_kwargs={"window_s": 0.25}, steal_batch=4,
               low_watermark=2)
# Multi-device paths (phase 17): a world of one rank over NCCL on the main
# path's graph, then two gloo ranks sharing the card on the paper's grid
# and on phase 10's stereo bucket. Each rank keeps only its slice, and its
# chain fold adds a vertex's in-edges in the one-device order, so a sharded
# run is bitwise the one-device run at any eps; (b) runs at the main path's.
DIST_EPS = 1e-3
# LBP does not converge on this grid: its runs are held at a cap.
DIST_ROUNDS = {"lbp": 500, "rnbp": 4000}
DIST_BANDED_ROUNDS = 200             # banded LBP's cap on the main graph
DIST_RANKS = 2
DIST_TIMEOUT_S = 240                 # process groups and the spawned world
DIST_SHARE = 0.6     # (c): a rank's graph and messages over one device's
# Resilient runs and the serial baseline.
RESILIENT_CHUNK = 200
SRBP_LIMIT_S = 10.0
KL_BOUND = 1e-6                      # RnBP on a chain vs variable elimination
# The LM stack's serving path (phase 18): every family at reduced() on the
# card against the CPU, Qwen3-4B's width at two layers (two q-blocks of
# 512), and Qwen3-4B as the repo publishes it (src/repro/configs/
# qwen3_4b.py: 36 layers, bf16) served at B = 4.
LM_TOL = 1e-4                        # card vs CPU in float32, abs and rel
LM_FAMILY = dict(b=2, s=8, steps=8)
LM_WIDE = dict(layers=2, b=1, s=1024)
LM_SERVE = dict(b=4, prefill_len=1024, prompt_len=64, gen=32,
                trace_steps=8)
# decode vs prefill in bf16: max|d logit| / max|logit| (the reference's own
# decode-matches-forward check, tests/test_models_smoke.py:98-120)
LM_DECODE_REL = 3e-2
# The LM stack's training path (phase 19): every family at reduced() on the
# card against the CPU and the train step's invariants there, Qwen3-4B's
# widths at two layers in float32, and Qwen3-4B as published trained ten
# steps at B = 1, S = 2,048.
LM_TRAIN_FAMILY = dict(b=2, s=16, steps=5, ckpt_at=3)
LM_TRAIN_WIDE = dict(layers=2, b=1, s=512)
LM_TRAIN = dict(b=1, s=2048, steps=10, base_lr=3e-4, warmup=2, synced=6,
                traced=(7, 8))
LM_TRAIN_REL = 1e-4                  # (b): loss relative, gradients of max
LM_TRAIN_EVAL = 3                    # (c): batches 0..2 evaluated on the
LM_TRAIN_DROP = 0.1                  # masters before and after training,
#                                      their mean lower by this much
#                                      (the prediction in PERF.md)
# The LM stack's sharded serving path (phase 20): the reduced families, all
# ten, tensor-parallel over "model" on a world of one over NCCL (bitwise one
# device) and on two gloo ranks sharing the card (within LM_TOL); Granite-MoE
# 3B-a800m as
# src/repro/configs/granite_moe_3b_a800m.py publishes it (32 layers, bf16)
# served on one device at B = 4, then over the two ranks with the
# "sharded" dispatch at full depth, in float32 and bf16.
LM_SHARD_FAMILIES = (("qwen3_4b", None), ("gemma_7b", None),
                     ("mistral_large_123b", None), ("starcoder2_3b", None),
                     ("pixtral_12b", None), ("granite_moe_3b_a800m", "ragged"),
                     ("granite_moe_3b_a800m", "dense"),
                     ("granite_moe_3b_a800m", "sharded"),
                     ("mamba2_130m", None), ("hymba_1_5b", None),
                     ("deepseek_v3_671b", None), ("whisper_medium", None))
LM_SHARD_FAMILY = dict(b=2, s=8, steps=8)
LM_SHARD_RANKS = 2
LM_SHARD_TIMEOUT_S = 420
LM_MOE_SERVE = dict(b=4, prefill_len=1024, prompt_len=64, gen=32,
                    trace_steps=8)
LM_MOE_SHARDED = dict(s=256, steps=16)
# The LM stack's sharded training path (phase 21): (a) the cases of the
# CPU tests (tests/test_torch_lm_sharded_train.py and
# test_torch_lm_sharded_blocks.py) -- all ten families tensor-parallel at
# reduced(), every family under "fsdp" at reduced()
# widened so ZeRO-3 shards the table and block matrices -- 3 steps, on a
# world of one over NCCL (bitwise one device's) and on two gloo ranks
# sharing the card (within LM_TOL, ranks bitwise); (b) Granite's published
# widths at 2 of 32 layers in float32 over the two ranks, gradients and
# masters within LM_TOL of one device; (c) Granite-MoE 3B-a800m as
# src/repro/configs/granite_moe_3b_a800m.py publishes it (32 layers, bf16
# over float32 masters, "sharded" dispatch) trained 5 steps over the two
# ranks at (1, 2), tensor-parallel, at base_lr 3e-5 (a schedule that does
# not spike: PERF.md, PR 18).
LM_STRAIN_TP = (("qwen3_4b", None), ("gemma_7b", None),
                ("mistral_large_123b", None), ("starcoder2_3b", None),
                ("pixtral_12b", None), ("granite_moe_3b_a800m", "ragged"),
                ("granite_moe_3b_a800m", "sharded"), ("mamba2_130m", None),
                ("hymba_1_5b", None), ("deepseek_v3_671b", None),
                ("whisper_medium", None))
# S counts pixtral's 8 stub patches: at S = 8 it would have no text token
LM_STRAIN_FAMILY = dict(b=4, s=16, steps=3, base_lr=1e-4, warmup=1)
LM_STRAIN_WIDE = dict(layers=2, b=2, s=512, steps=3, base_lr=1e-4,
                      warmup=1)
LM_STRAIN = dict(b=2, s=1024, steps=5, base_lr=3e-5, warmup=2)
LM_STRAIN_RANKS = 2
LM_STRAIN_SHARE = 0.6        # (c): a rank's state over one device's, at most
LM_STRAIN_TIMEOUT_S = 600
# The LM stack's tensor-parallel SSM, hybrid, MLA and encoder-decoder
# blocks (phase 22), over two gloo ranks sharing the card at (1, 2): (a)
# Mamba2-130M as src/repro/configs/mamba2_130m.py publishes it (24 layers,
# d 768, 24 heads of 64, state 128, bf16) -- in float32 served (prefill
# over 1,024 tokens, 32 decode steps) against one device, and on a world
# of one over NCCL bitwise one device; step 0's gradients at full depth no
# farther from one device's than one device's on the CPU are (float32's
# own floor there exceeds 1e-4 of a leaf's max); trained 3 steps at its
# widths and 2 of 24 layers against one device; in bf16 served and timed;
# trained 5 steps in bf16 over float32 masters -- and
# (b) in float32 at two layers, the published widths of Hymba-1.5B,
# DeepSeek-V3 (MLA and the MTP head; both layers dense, as its lead-in
# layers are) and Whisper-medium (2 encoder and 2 decoder layers): prefill
# over 256 tokens, 16 decode steps and step 0's gradients against one
# device.
LM_BLOCKS_F32 = dict(b=2, s=1024, steps=32)
LM_BLOCKS_F32_GRADS = dict(b=2, s=256)
LM_BLOCKS_F32_TRAIN = dict(layers=2, b=2, s=1024, steps=3, base_lr=1e-4,
                           warmup=1)
LM_BLOCKS_SERVE = dict(b=4, s=1024, steps=32)
LM_BLOCKS_TRAIN = dict(b=2, s=1024, steps=5, base_lr=1e-3, warmup=2)
LM_BLOCKS_WIDE = dict(layers=2, b=2, s=256, steps=16)
LM_BLOCKS_RANKS = 2
LM_BLOCKS_TIMEOUT_S = 600
LM_METRIC_TOL = 1e-5                 # train metrics against one device
# Serving over sub-meshes (phase 23): four gloo ranks sharing the card, two
# sub-meshes of two; phase 14's stream cut to its first frames and a
# shorter zoo stream, at phase 14's config on "sharded". Two zoo graphs
# after each frame put the frames at rids 0, 3, 6, 9, so round robin sends
# frames to both replicas.
SUB_RANKS, SUB_MESHES = 4, ((0, 1), (2, 3))
SUB_FRAMES, SUB_ZOO = 4, 8
SUB_TIMEOUT_S = 240                  # process groups and the spawned world
# Phase 15's skewed stream with more fast grids: least_loaded splits it
# evenly, so the replica pinned by the straggler keeps a backlog in its
# inbox after the other drains its share -- and a steal.
SUB_SKEW_FAST = 62
# The entry points (phase 25): each driver of repro_torch.examples called as
# a user calls it, in this process, on the card by default: quickstart as
# published; stereo_bp at phase 10's Tsukuba frame; ldpc_decode at its
# defaults; bp_serving's async pipeline and its router over zoo_stream(36);
# train_lm with its resume drill. distributed_bp runs inside phase 17's
# gloo world (ENTRY_DIST_SIZE).
ENTRY_ARGV = {
    "quickstart": [],
    "stereo_bp": ["--height", str(STEREO["height"]), "--width",
                  str(STEREO["width"]), "--disp", str(STEREO["n_disp"])],
    "ldpc_decode": [],
    "bp_serving/async": ["--async", "--workload", "mixed",
                         "--requests", "36"],
    "bp_serving/routed": ["--workload", "mixed", "--requests", "36",
                          "--replicas", "2", "--routing", "least_loaded",
                          "--steal"],
    "train_lm": ["--steps", "20"],
}
ENTRY_DIST_SIZE = 32
# The port's pages of the docs' executable spec (phase 26), run on the card
# in this order; then README's first port block at its full size.
DOCS_PAGES = ("engine.md", "schedulers.md", "serving.md", "admission.md",
              "router.md", "workloads.md", "kernels.md", "sharding.md")
#: dense bf16 tensor-core peaks (NVIDIA data sheets, no sparsity), by a
#: substring of the device name; the first match wins
BF16_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H200", 989e12),
              ("H100", 989e12))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    """(bytes/s, float32 flop/s) of the card, from the port's roofline
    model (``repro_torch.roofline.kernel_model.CARD_PEAKS``)."""
    from repro_torch.roofline.kernel_model import card_peaks as peaks
    return peaks(name)


def bf16_peak(name: str) -> float:
    """The card's dense bf16 peak FLOP/s (``BF16_PEAKS``)."""
    for key, peak in BF16_PEAKS:
        if key in name:
            return peak
    raise RuntimeError(f"no published bf16 peak for {name!r}; add it to "
                       "BF16_PEAKS")


def bound(e: int, s: int, semiring: str, bw: float, f32: float):
    """(bound_ms, bound_by) of one fused update over e edges of s states:
    the port's roofline model (``fused_update_cost``: each input read once,
    each output written once, (S^2+3S+1)*4 + S bytes per edge) against the
    card's memory rate and float32 peak."""
    from repro_torch.roofline.kernel_model import bound_ms, fused_update_cost
    return bound_ms(fused_update_cost(e, s, semiring=semiring), bw, f32)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call on the card, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of the CUDA kernels ``fn`` launches, from
    a ``torch.profiler`` trace of ``iters`` warm calls: the kernel's own
    time, without the host's launch overhead that CUDA events around
    back-to-back calls include when a call is short. 0.0 off the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return 0.0
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.time_range.elapsed_us() for ev in prof.events()
                if ev.device_type == DeviceType.CUDA)
    return total / iters / 1e3


def random_operands(e: int, s: int, gen, device):
    """Kernel inputs with NEG_INF invalid states, all-masked rows (every
    7th edge) and source rows with no valid state (every 11th edge)."""
    import torch
    kw = dict(generator=gen, device=device)
    logpsi = torch.randn((e, s, s), **kw)
    valid_dst = torch.rand((e, s), **kw) < 0.8
    valid_dst[::7] = False
    valid_src = torch.rand((e, s), **kw) < 0.8
    valid_src[::11] = False
    pre = torch.where(valid_src, 3.0 * torch.randn((e, s), **kw), NEG_INF)
    logm = torch.where(valid_dst, 2.0 * torch.randn((e, s), **kw) - 3.0,
                       NEG_INF)
    return logpsi, pre, logm, valid_dst.to(torch.int8)


def compare(semiring: str, kern, plain) -> float:
    """Largest |kernel - plain| over finite entries; raises when NEG_INF
    entries differ, when max-product is not bitwise equal, or when
    sum-product differs by more than SUM_TOL."""
    import torch
    (nk, rk), (np_, rp) = kern, plain
    if not torch.equal(nk == NEG_INF, np_ == NEG_INF):
        raise AssertionError(f"{semiring}: NEG_INF entries differ")
    if semiring == "max":
        if not (torch.equal(nk, np_) and torch.equal(rk, rp)):
            raise AssertionError("max-product kernel is not bitwise equal "
                                 "to its plain version")
        return 0.0
    finite = nk != NEG_INF
    err = max(float((nk - np_).abs()[finite].max()) if bool(finite.any())
              else 0.0, float((rk - rp).abs().max()) if rk.numel() else 0.0)
    if not err <= SUM_TOL:
        raise AssertionError(f"sum-product kernel differs from its plain "
                             f"version by {err} > {SUM_TOL}")
    return err


def first_edges(t, k: int, edges_last: bool):
    """The first ``k`` edges of an operand or output, as a new contiguous
    tensor: rows of an edge-major tensor, columns (the last axis) of a
    transposed one; a 1-D tensor is always per edge."""
    if edges_last and t.dim() > 1:
        return t[..., :k].contiguous()
    return t[:k].contiguous()


def check_sub_launch(name, fn, ops, kern, k, edges_last=False) -> None:
    """The first ``k`` edges launched alone give bitwise the output they
    have inside the full launch ``kern = fn(*ops)``; raises otherwise. An
    edge's arithmetic must not depend on E or on its place in the launch.
    The phases run it on the card only: the plain versions on the CPU are
    vectorized over edges and may round an edge's last bit by its place."""
    import torch
    k = min(k, int(ops[1].shape[-1 if edges_last else 0]))
    part = fn(*(first_edges(t, k, edges_last) for t in ops))
    if not all(torch.equal(p, first_edges(f, k, edges_last))
               for p, f in zip(part, kern)):
        raise AssertionError(f"{name}: the first {k} edges launched alone "
                             "differ from the same edges in the full launch")


def phase_kernels(device, states=CHECK_STATES, edges=CHECK_EDGES,
                  table_bytes=CHECK_TABLE_BYTES, sub=SUB_EDGES):
    """Kernel vs plain version for both semirings over S x E, and the first
    ``sub`` edges alone against the full launch, bitwise."""
    import torch
    from repro_torch.kernels.ref import fused_update_e_ref
    from repro_torch.kernels.triton_update import fused_update_e
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {"sum": 0.0, "max": 0.0}
    for s in states:
        for e_want in edges:
            e = min(e_want, max(1, table_bytes // (4 * s * s)))
            ops = random_operands(e, s, gen, device)
            for semiring in ("sum", "max"):
                def fn(*o, semiring=semiring):
                    return fused_update_e(*o, semiring=semiring)
                kern = fn(*ops)
                plain = fused_update_e_ref(*ops, semiring=semiring)
                sync(device)
                err = compare(semiring, kern, plain)
                if device.type == "cuda":
                    check_sub_launch(f"fused_update_e/{semiring} S={s} "
                                     f"E={e}", fn, ops, kern, sub)
                worst[semiring] = max(worst[semiring], err)
                log(f"  S={s:3d} E={e:9d} {semiring}: max_abs_err={err:.3g}, "
                    f"first {min(sub, e)} edges alone: bitwise"
                    + ("" if e == e_want else f" (E cut from {e_want})"))
            del ops, kern, plain
    return worst


def run_engine(pgm, device, *, scheduler="lbp", scheduler_kwargs=(),
               eps=1e-3, max_rounds=2000, backend="triton", seed=0):
    """One ``BPEngine.run``; returns (result, seconds) with the card
    synchronized before the clock stops."""
    import torch
    from repro_torch.core import BPConfig, BPEngine
    engine = BPEngine(BPConfig(scheduler=scheduler,
                               scheduler_kwargs=scheduler_kwargs, eps=eps,
                               max_rounds=max_rounds, backend=backend),
                      device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(pgm, gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_beliefs(pgm, res, padded=False) -> None:
    """Finite log-marginals of shape (V, S) that normalize over the valid
    states of every real vertex; ``padded``: a result padded to a bucket
    shape, held over the graph's own (V, S)."""
    import torch
    b = res.beliefs
    shape = (pgm.n_vertices, pgm.n_states_max)
    if tuple(b.shape) != shape and not (padded and b.shape[0] >= shape[0]
                                        and b.shape[1] >= shape[1]):
        raise AssertionError(f"beliefs shape {tuple(b.shape)}")
    b = b[:shape[0], :shape[1]]
    if not bool(torch.isfinite(b).all()):
        raise AssertionError("non-finite beliefs")
    n = pgm.n_real_vertices
    p = torch.where(pgm.state_mask[:n].to(b.device), b[:n].exp(),
                    0.0).sum(dim=1)
    if not bool(((p - 1.0).abs() < 1e-4).all()):
        raise AssertionError("beliefs do not normalize")


def phase_main(device, n=MAIN_N, c=MAIN_C):
    """The port's main path: RnBP on an n x n Ising grid through the
    kernel backend, launch counts reset just before and read just after."""
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as K
    from repro_torch.pgm import ising_grid_fast
    t0 = time.perf_counter()
    pgm = ising_grid_fast(n, c, seed=0, device=device)
    build_s = time.perf_counter() - t0
    K.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    res, secs = run_engine(pgm, device, scheduler="rnbp",
                           scheduler_kwargs=MAIN_KW, eps=1e-3,
                           max_rounds=2000, backend="triton")
    launches = dict(K.LAUNCHES, t=MU.LAUNCHES["sum"],
                    prelude=EP.LAUNCHES["edge_prelude"])
    rounds = int(res.rounds)
    check_beliefs(pgm, res)
    if launches["sum"] < max(rounds, 1):
        raise AssertionError(f"kernel launches {launches['sum']} < rounds "
                             f"{rounds}: the main path bypassed the kernel")
    out = dict(graph=f"ising_grid_fast({n}, {c}, seed=0)", n_edges=pgm.n_edges,
               n_vertices=pgm.n_vertices, graph_build_s=build_s,
               rounds=rounds, converged=bool(res.converged),
               max_residual=float(res.max_residual),
               updates=int(res.updates), run_s=secs,
               ms_per_round=secs * 1e3 / max(rounds, 1), launches=launches)
    return pgm, res, out


def phase_paper(device, n=PAPER_N, protein_vertices=120):
    """LBP/RBP/RS/RnBP on Ising n x n (C=2.5) and on the protein-like MRF,
    then max-product LBP through the kernel (its own launch count) against
    the plain max-product backend."""
    import torch
    from repro_torch.core.messages import map_assignment
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import triton_update as K
    from repro_torch.kernels.ops import make_triton_update
    from repro_torch.pgm import ising_grid_fast, protein_like_graph
    graphs = {f"ising{n}": ising_grid_fast(n, 2.5, seed=0, device=device),
              "protein": protein_like_graph(protein_vertices, seed=0,
                                            device=device)}
    scheds = (("lbp", {}), ("rbp", {}), ("rs", {}), ("rnbp", MAIN_KW))
    rows = []
    for gname, pgm in graphs.items():
        for sname, kw in scheds:
            res, secs = run_engine(pgm, device, scheduler=sname,
                                   scheduler_kwargs=kw)
            check_beliefs(pgm, res)
            row = dict(graph=gname, scheduler=sname, rounds=int(res.rounds),
                       converged=bool(res.converged), run_s=secs,
                       edges=pgm.n_edges, states=pgm.n_states_max)
            rows.append(row)
            log(f"  {gname:8s} {sname:5s} rounds={row['rounds']:5d} "
                f"converged={row['converged']} {secs * 1e3:.1f} ms")
    pgm = graphs[f"ising{n}"]
    K.reset_launch_counts()
    EP.reset_launch_counts()
    res_k, secs = run_engine(pgm, device, scheduler="lbp", max_rounds=500,
                             backend=make_triton_update(semiring="max"))
    max_launches = K.LAUNCHES["max"]
    max_prelude = EP.LAUNCHES["edge_prelude"]
    res_p, _ = run_engine(pgm, device, scheduler="lbp", max_rounds=500,
                          backend="maxprod")
    if max_launches < max(int(res_k.rounds), 1):
        raise AssertionError("max-product path bypassed the kernel")
    map_k = map_assignment(pgm, res_k.logm)
    map_p = map_assignment(pgm, res_p.logm)
    if int(res_k.rounds) != int(res_p.rounds) or not torch.equal(map_k, map_p) \
            or not torch.equal(res_k.logm, res_p.logm):
        raise AssertionError("max-product kernel path differs from the plain "
                             "max-product backend")
    mapd = dict(graph=f"ising{n}", rounds=int(res_k.rounds),
                converged=bool(res_k.converged), run_s=secs,
                launches=max_launches, prelude_launches=max_prelude,
                ones=int(map_k[:pgm.n_real_vertices].sum()))
    log(f"  MAP ising{n}: rounds={mapd['rounds']} converged="
        f"{mapd['converged']} launches={max_launches} bitwise == maxprod")
    return rows, mapd


def phase_card_vs_cpu(device, n=CPU_N, c=CPU_C):
    """LBP through the kernel on the card and its plain version on the CPU:
    equal rounds, beliefs within 1e-4."""
    import torch
    from repro_torch.pgm import ising_grid_fast
    cpu = torch.device("cpu")
    res_d, _ = run_engine(ising_grid_fast(n, c, seed=0, device=device), device)
    res_c, _ = run_engine(ising_grid_fast(n, c, seed=0, device=cpu), cpu)
    diff = float((res_d.beliefs.cpu().exp() - res_c.beliefs.exp()).abs().max())
    if int(res_d.rounds) != int(res_c.rounds) or not diff <= 1e-4:
        raise AssertionError(f"card vs CPU: rounds {int(res_d.rounds)} vs "
                             f"{int(res_c.rounds)}, belief diff {diff}")
    return dict(graph=f"ising_grid_fast({n}, {c})", rounds=int(res_d.rounds),
                max_prob_diff=diff)


def phase_timing(pgm, device, bw, f32, protein):
    """CUDA-event times of the kernel and its plain version at the main
    path's shape and at the protein-like MRF's shape, plus the other parts
    of one main-path round."""
    import torch
    from repro_torch.core import messages as M
    from repro_torch.core.schedulers import RnBP
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels.ref import fused_update_e_ref
    from repro_torch.kernels.triton_update import fused_update_e
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_t_ref
    out = {}
    for name, g in (("main", pgm), ("protein", protein)):
        logm = M.init_messages(g)
        pre = M.edge_prelude(g, logm)
        ops = (g.log_psi_e, pre, logm, g.dst_mask)
        e, s = g.n_edges, g.n_states_max
        for semiring in ("sum", "max"):
            def kern(semiring=semiring):
                return fused_update_e(*ops, semiring=semiring)
            k_ms = time_ms(kern, 50)
            p_ms = time_ms(lambda: fused_update_e_ref(*ops, semiring=semiring),
                           10)
            b_ms, b_by = bound(e, s, semiring, bw, f32)
            out[f"{name}/{semiring}"] = dict(E=e, S=s, ms=k_ms, plain_ms=p_ms,
                                             device_ms=device_ms(kern),
                                             bound_ms=b_ms, bound_by=b_by)
            log(f"  {name:7s} {semiring}: E={e} S={s} kernel {k_ms:.4f} ms "
                f"(device {out[f'{name}/{semiring}']['device_ms']:.4f}), "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # fused_update_t at the one-graph shape (the protein shape is phase 12's)
    logm = M.init_messages(pgm)
    logpsi_t, dmask_t = pgm.operands_t
    ops_t = (logpsi_t, M.edge_prelude(pgm, logm).t().contiguous(),
             logm.t().contiguous(), dmask_t)
    err = compare("sum", fused_update_t(*ops_t), fused_update_t_ref(*ops_t))
    e, s = pgm.n_edges, pgm.n_states_max
    b_ms, b_by = bound(e, s, "sum", bw, f32)
    out["main/t"] = dict(E=e, S=s, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by,
                         ms=time_ms(lambda: fused_update_t(*ops_t), 50),
                         device_ms=device_ms(lambda: fused_update_t(*ops_t)),
                         plain_ms=time_ms(lambda: fused_update_t_ref(*ops_t),
                                          10))
    log(f"  main    fused_update_t: E={e} S={s} kernel "
        f"{out['main/t']['ms']:.4f} ms (device "
        f"{out['main/t']['device_ms']:.4f}), plain "
        f"{out['main/t']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err={err:.3g}")
    del ops_t, logpsi_t, dmask_t
    # One main-path round, part by part.
    logm = M.init_messages(pgm)
    cand, r = fused_update_e(pgm.log_psi_e, M.edge_prelude(pgm, logm), logm,
                             pgm.dst_mask)
    sched = RnBP(**MAIN_KW)
    st = sched.init(pgm)
    gen = torch.Generator(device=device).manual_seed(1)
    unc = ((r >= 1e-3) & pgm.edge_mask).sum().to(torch.int32)
    frontier, _ = sched.select(pgm, r, 1e-3, gen, st, unc)
    parts = {
        "edge_prelude": lambda: EP.edge_prelude(pgm, logm),
        "  messages.edge_prelude (torch)": lambda: M.edge_prelude(pgm, logm),
        "  vertex_logprod": lambda: M.vertex_logprod(pgm, logm),
        "unconverged_count": lambda: ((r >= 1e-3) & pgm.edge_mask).sum(),
        "rnbp_select": lambda: sched.select(pgm, r, 1e-3, gen, st, unc),
        "apply_frontier": lambda: M.apply_frontier(logm, cand, frontier),
    }
    out["round_parts_ms"] = {k: time_ms(f, 20) for k, f in parts.items()}
    for k, v in out["round_parts_ms"].items():
        log(f"  round part {k}: {v:.4f} ms")
    return out


def phase_trace(graph, device, warm=64, rounds=32, config=None, rng=None):
    """Device time by kernel over ``rounds`` rounds of ``graph`` (one graph
    or a bucket) after ``warm`` rounds, from a ``torch.profiler`` trace,
    and the device's busy share against the same window timed without the
    profiler. ``config`` defaults to the one-graph main path's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import BPConfig, BPEngine
    eng = BPEngine(config or BPConfig(
        scheduler="rnbp", scheduler_kwargs=MAIN_KW, eps=1e-3,
        max_rounds=2000, backend="triton"), device=device)
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    state = eng.step(eng.init(graph, rng), chunk_rounds=warm)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    eng.step(state, chunk_rounds=rounds)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        eng.step(state, chunk_rounds=rounds)
        sync()
    by_name, n_kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
            n_kernels += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(rounds=rounds, wall_ms_per_round=wall_ms / rounds,
                device_ms_per_round=device_ms / rounds,
                busy_share=device_ms / wall_ms,
                kernels_per_round=n_kernels / rounds,
                top_ms_per_round={k: v / rounds for k, v in top})


def phase_kernels_t(device, states=CHECK_T_STATES, edges=CHECK_T_EDGES,
                    table_bytes=CHECK_TABLE_BYTES, sub=SUB_EDGES):
    """The TPU-layout kernel ``fused_update_t`` vs its plain version over
    S x E, operands transposed from ``random_operands``, and the first
    ``sub`` edges alone against the full launch, bitwise."""
    import torch
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_t_ref
    gen = torch.Generator(device=device).manual_seed(1)
    worst = 0.0
    for s in states:
        for e_want in edges:
            e = min(e_want, max(1, table_bytes // (4 * s * s)))
            logpsi, pre, logm, dmask = random_operands(e, s, gen, device)
            ops = (logpsi.permute(1, 2, 0).contiguous(), pre.t().contiguous(),
                   logm.t().contiguous(), dmask.t().contiguous())
            del logpsi, pre, logm, dmask
            kern = fused_update_t(*ops)
            plain = fused_update_t_ref(*ops)
            sync(device)
            err = compare("sum", kern, plain)
            if device.type == "cuda":
                check_sub_launch(f"fused_update_t S={s} E={e}",
                                 fused_update_t, ops, kern, sub,
                                 edges_last=True)
            worst = max(worst, err)
            log(f"  S={s:3d} E={e:9d} sum: max_abs_err={err:.3g}, first "
                f"{min(sub, e)} edges alone: bitwise"
                + ("" if e == e_want else f" (E cut from {e_want})"))
            del ops, kern, plain
    return worst


def batched_config(max_rounds=STEREO_ROUNDS):
    """The batched main path's config: RnBP through both ``"pallas"``
    backends."""
    from repro_torch.core import BPConfig
    return BPConfig(scheduler="rnbp", scheduler_kwargs=MAIN_KW, eps=1e-3,
                    max_rounds=max_rounds, backend="pallas",
                    batch_backend="pallas")


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def instrument(engine, counts):
    """Shadow ``engine.run`` and ``engine.step`` so that every ``run`` --
    one per bucket under ``run_many`` -- appends a record to the returned
    list: the bucket's shape, its loop iterations (rounds in which some
    graph was active), its largest round count, the kernel launches it
    added to ``counts["sum"]`` and its seconds on the host clock, the card
    synchronized at both ends. ``del engine.run, engine.step`` undoes it."""
    records, iters = [], []
    run, step = engine.run, engine.step

    def counted_step(state, **kw):
        out = step(state, **kw)
        iters.append(int(out.chunk_iters))
        return out

    def counted_run(graph, rng=None, **kw):
        sync(graph.device)
        iters.clear()
        before, t0 = counts["sum"], time.perf_counter()
        res = run(graph, rng, **kw)
        sync(graph.device)
        records.append(dict(
            size=graph.size, edges=graph.n_edges, states=graph.n_states_max,
            seconds=time.perf_counter() - t0, iterations=sum(iters),
            rounds=int(res.rounds.max()), launches=counts["sum"] - before))
        return res

    engine.run, engine.step = counted_run, counted_step
    return records


def check_bucket_launches(label, records) -> None:
    """Each bucket's kernel launches cover its loop iterations, which
    cover its rounds."""
    for b in records:
        if b["launches"] < max(b["iterations"], 1) or \
                b["iterations"] < b["rounds"]:
            raise AssertionError(f"{label}: bucket {b} bypassed the kernel")


def same_result(a, b, i=None) -> bool:
    """Every field of result ``b`` bitwise equal to ``a`` (row ``i`` of a
    bucket's result when given)."""
    import torch
    for f in RESULT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if not isinstance(x, torch.Tensor):
            continue
        if not torch.equal(x if i is None else x[i], y):
            return False
    return True


def phase_batched(device, frames=STEREO_FRAMES, scene=STEREO,
                  max_rounds=STEREO_ROUNDS):
    """The batched main path: ``run_many`` over ``frames`` stereo scenes
    (one bucket) through the ``"pallas"`` backends, launch counts reset
    just before and read just after; then slot 0 against a solo run of
    ``batch.graph(0)`` with its own generator, bitwise."""
    import torch
    from repro_torch.core import BPEngine, bucket_pgms, slot_generator
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import stereo_mrf
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    scenes = [stereo_mrf(scene["height"], scene["width"], scene["n_disp"],
                         seed=s, device=device) for s in range(frames)]
    pgms = [sc.pgm for sc in scenes]
    build_s = time.perf_counter() - t0
    eng = BPEngine(batched_config(max_rounds), device=device)
    records = instrument(eng, MU.LAUNCHES)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    MU.reset_launch_counts()
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run_many(pgms, 0)
    sync(device)
    run_s = time.perf_counter() - t0
    launches, other = MU.LAUNCHES["sum"], dict(TT.LAUNCHES)
    prelude = EP.LAUNCHES["edge_prelude"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del eng.run, eng.step
    if len(records) != 1:
        raise AssertionError(f"{len(records)} buckets, expected one")
    check_bucket_launches("stereo", records)
    loop = records[0]
    frames_out = []
    for sc, pgm, res in zip(scenes, pgms, results):
        check_beliefs(pgm, res)
        n = pgm.n_real_vertices
        labels = res.beliefs[:n, :sc.n_disp].argmax(dim=1).cpu().numpy()
        frames_out.append(dict(rounds=int(res.rounds),
                               converged=bool(res.converged),
                               max_residual=float(res.max_residual),
                               within_1_of_truth=sc.accuracy(labels)))
    bucket, = bucket_pgms(pgms)
    gi = bucket.indices[0]
    solo = eng.run(bucket.batch.graph(0), slot_generator(0, gi, device))
    if not same_result(solo, results[gi]):
        raise AssertionError("slot 0 of the stereo bucket differs from its "
                             "solo run")
    out = dict(graph=f"{frames} x stereo_mrf({scene['height']}, "
               f"{scene['width']}, {scene['n_disp']}, seed=0..{frames - 1})",
               batch=bucket.batch.size, n_edges=bucket.batch.n_edges,
               n_vertices=bucket.batch.n_vertices,
               n_states=bucket.batch.n_states_max, graph_build_s=build_s,
               run_many_s=run_s, loop_s=loop["seconds"],
               bucketing_s=run_s - loop["seconds"],
               iterations=loop["iterations"],
               ms_per_iteration=loop["seconds"] * 1e3
               / max(loop["iterations"], 1),
               launches=launches, other_launches=other,
               prelude_launches=prelude,
               peak_memory_bytes=peak, frames=frames_out,
               slot0_bitwise_solo=True, solo_rounds=int(solo.rounds))
    return bucket.batch, out


def phase_zoo(device, n=ZOO_N, eps=ZOO_EPS, max_rounds=ZOO_ROUNDS):
    """``run_many`` over ``zoo_stream(n)`` with LBP on the card, through the
    fold path (``backend="pallas"``) and through ``batch_backend="triton"``,
    against the CPU's plain path: a request that converges on the CPU
    converges on the card in as many rounds with beliefs within 1e-4; one
    that does not, does not. Each bucket's kernel launches cover its loop
    iterations."""
    import torch
    from repro_torch.core import BPConfig, BPEngine
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import zoo_stream
    cpu = torch.device("cpu")
    cfg = BPConfig(scheduler="lbp", eps=eps, max_rounds=max_rounds)
    kinds = [k for k, _ in zoo_stream(n, seed=0, device=cpu)]
    ref = BPEngine(cfg, device=cpu).run_many(
        [p for _, p in zoo_stream(n, seed=0, device=cpu)], 0)
    pgms = [p for _, p in zoo_stream(n, seed=0, device=device)]
    out = {}
    for label, over, counts in (
            ("fold/pallas", dict(backend="pallas"), MU.LAUNCHES),
            ("batch/triton", dict(batch_backend="triton"), TT.LAUNCHES)):
        eng = BPEngine(dataclasses.replace(cfg, **over), device=device)
        per_bucket = instrument(eng, counts)
        MU.reset_launch_counts()
        TT.reset_launch_counts()
        EP.reset_launch_counts()
        res = eng.run_many(pgms, 0)
        prelude = EP.LAUNCHES["edge_prelude"]
        del eng.run, eng.step
        check_bucket_launches(label, per_bucket)
        worst, unconverged = 0.0, []
        for i, (r_card, r_cpu) in enumerate(zip(res, ref)):
            if not bool(r_cpu.converged):
                unconverged.append(i)
                if bool(r_card.converged):
                    raise AssertionError(f"{label}: request {i} converged on "
                                         "the card, not on the CPU")
                continue
            diff = float((r_card.beliefs.cpu().exp()
                          - r_cpu.beliefs.exp()).abs().max())
            if not bool(r_card.converged) or not diff <= 1e-4 or \
                    int(r_card.rounds) != int(r_cpu.rounds):
                raise AssertionError(
                    f"{label}: request {i} ({kinds[i]}) rounds "
                    f"{int(r_card.rounds)} vs {int(r_cpu.rounds)} on the CPU, "
                    f"converged {bool(r_card.converged)}, belief diff {diff}")
            worst = max(worst, diff)
        out[label] = dict(buckets=per_bucket, max_prob_diff=worst,
                          prelude_launches=prelude,
                          not_converged_on_cpu=unconverged,
                          rounds=[int(r.rounds) for r in res])
        log(f"  {label}: {len(pgms)} requests in {len(per_bucket)} buckets, "
            f"rounds equal to the CPU's, max belief diff {worst:.3g}, "
            f"not converged on the CPU: {unconverged or 'none'}")
        for rec in per_bucket:
            log(f"    bucket B={rec['size']} E={rec['edges']} "
                f"S={rec['states']}: {rec['iterations']} iterations, "
                f"{rec['launches']} launches")
    out["kinds"] = kinds
    return out


def phase_protein_pallas(device, protein_vertices=120):
    """RnBP on the protein-like MRF (S = 81) through the ``"pallas"``
    backend: ``fused_update_t``'s launches at that shape, counts reset just
    before and read just after."""
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.pgm import protein_like_graph
    pgm = protein_like_graph(protein_vertices, seed=0, device=device)
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    res, secs = run_engine(pgm, device, scheduler="rnbp",
                           scheduler_kwargs=MAIN_KW, backend="pallas")
    launches = MU.LAUNCHES["sum"]
    prelude = EP.LAUNCHES["edge_prelude"]
    check_beliefs(pgm, res)
    if launches < max(int(res.rounds), 1):
        raise AssertionError("the protein run bypassed fused_update_t")
    return dict(graph=f"protein_like_graph({protein_vertices}, seed=0)",
                rounds=int(res.rounds), converged=bool(res.converged),
                launches=launches, prelude_launches=prelude, run_s=secs)


def widest_bucket(device, n=ZOO_N):
    """The zoo stream's bucket with the most states."""
    from repro_torch.core import bucket_pgms
    from repro_torch.pgm import zoo_stream
    buckets = bucket_pgms([p for _, p in zoo_stream(n, seed=0,
                                                    device=device)])
    return max(buckets, key=lambda b: b.batch.n_states_max).batch


def phase_timing_batched(batch, others, device, bw, f32):
    """Both kernels held against their plain versions on a bucket's union
    -- the operands the batched main path gives them -- and CUDA-event
    times of each kernel and plain version (``fused_update_e`` in both
    semirings), at the stereo bucket's shape and at each of ``others``
    (name -> bucket); then the parts of one batched round of the stereo
    bucket."""
    import torch
    from repro_torch.core import messages as M
    from repro_torch.core.batch import batch_generators
    from repro_torch.core.schedulers import RnBP
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
    from repro_torch.kernels.triton_update import fused_update_e
    out = {}
    for name, b in (("stereo", batch), *others.items()):
        union = b.folded()
        logm = M.init_messages(union)
        pre = M.edge_prelude(union, logm)
        logpsi_t, dmask_t = union.operands_t
        ops_t = (logpsi_t, pre.t().contiguous(), logm.t().contiguous(),
                 dmask_t)
        ops_e = (union.log_psi_e, pre, logm, union.dst_mask)
        e, s = union.n_edges, union.n_states_max
        err = compare("sum", fused_update_t(*ops_t), fused_update_t_ref(*ops_t))
        b_ms, b_by = bound(e, s, "sum", bw, f32)
        row = dict(B=b.size, E=e, S=s, max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by,
                   ms=time_ms(lambda: fused_update_t(*ops_t), 50),
                   device_ms=device_ms(lambda: fused_update_t(*ops_t)),
                   plain_ms=time_ms(lambda: fused_update_t_ref(*ops_t), 10),
                   e={})
        log(f"  {name:7s} B={b.size} E={e} S={s}: fused_update_t "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max_abs_err={err:.3g}")
        for semiring in ("sum", "max"):
            def kern(semiring=semiring):
                return fused_update_e(*ops_e, semiring=semiring)

            def plain(semiring=semiring):
                return fused_update_e_ref(*ops_e, semiring=semiring)
            e_err = compare(semiring, kern(), plain())
            eb_ms, eb_by = bound(e, s, semiring, bw, f32)
            row["e"][semiring] = dict(
                max_abs_err=e_err, bound_ms=eb_ms, bound_by=eb_by,
                ms=time_ms(kern, 50), device_ms=device_ms(kern),
                plain_ms=time_ms(plain, 10))
            log(f"  {name:7s} fused_update_e/{semiring}: "
                f"{row['e'][semiring]['ms']:.4f} ms (device "
                f"{row['e'][semiring]['device_ms']:.4f}), plain "
                f"{row['e'][semiring]['plain_ms']:.4f} ms, bound "
                f"{eb_ms:.4f} ms ({eb_by}), max_abs_err={e_err:.3g}")
        out[name] = row
        del ops_t, ops_e, pre, logm
    # One batched round of the stereo bucket, part by part.
    union = batch.folded()
    bsz, e_b, s = batch.size, batch.n_edges, batch.n_states_max
    logm = M.init_messages(union)
    pre = M.edge_prelude(union, logm)
    logpsi_t, dmask_t = union.operands_t
    pre_t, logm_t = pre.t().contiguous(), logm.t().contiguous()
    new_t, resid = fused_update_t(logpsi_t, pre_t, logm_t, dmask_t)
    cand = new_t.t().contiguous().reshape(bsz, e_b, s)
    r = resid.reshape(bsz, e_b)
    sched = RnBP(**MAIN_KW)
    st = sched.init_batch(batch)
    gens = batch_generators(1, bsz, device)
    unc = ((r >= 1e-3) & batch.pgm.edge_mask).sum(dim=1).to(torch.int32)
    frontier, _ = sched.select_batch(batch, r, 1e-3, gens, st, unc)
    lm = logm.reshape(bsz, e_b, s)
    vsum = M.vertex_logprod(union, logm)
    src, rev = union.edge_src, union.edge_rev
    parts = {
        "edge_prelude": lambda: EP.edge_prelude(union, logm),
        "  messages.edge_prelude (torch)": lambda: M.edge_prelude(union,
                                                                 logm),
        "  vertex_logprod": lambda: M.vertex_logprod(union, logm),
        "  gather logm[in_edges]": lambda: logm[union.in_edges],
        "  gather vsum[edge_src]": lambda: vsum[src],
        "  gather logm[edge_rev]": lambda: logm[rev],
        "  gather log_psi_v[edge_src]": lambda: union.log_psi_v[src],
        "  gather state_mask[edge_src]": lambda: union.state_mask[src],
        "transposes (pre, logm in; new out)": lambda: (
            pre.t().contiguous(), logm.t().contiguous(),
            new_t.t().contiguous()),
        "fused_update_t": lambda: fused_update_t(logpsi_t, pre_t, logm_t,
                                                 dmask_t),
        "unconverged_count": lambda: ((r >= 1e-3) & batch.pgm.edge_mask).sum(
            dim=1),
        "rnbp_select_batch (B draws)": lambda: sched.select_batch(
            batch, r, 1e-3, gens, st, unc),
        "apply_frontier": lambda: M.apply_frontier(lm, cand, frontier),
    }
    out["round_parts_ms"] = {k: time_ms(f, 20) for k, f in parts.items()}
    for k, v in out["round_parts_ms"].items():
        log(f"  round part {k}: {v:.4f} ms")
    return out


def rnbp_messages(graph, device, rounds=(0, 8, 32)):
    """The messages of a real RnBP run (``MAIN_KW``, ``"triton"``) on
    ``graph`` -- one graph, or a bucket whose messages are its union's
    rows -- after each count of ``rounds``, as (E, S) copies."""
    import torch
    from repro_torch.core import BatchedPGM, BPConfig, BPEngine
    from repro_torch.core import slot_generator
    eng = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs=MAIN_KW,
                            eps=1e-3, max_rounds=max(rounds) + 1,
                            backend="triton"), device=device)
    gen = ([slot_generator(0, i, device) for i in range(graph.size)]
           if isinstance(graph, BatchedPGM)
           else torch.Generator(device=device).manual_seed(0))
    state, done, out = eng.init(graph, gen), 0, []
    for r in rounds:
        if r > done:
            state, done = eng.step(state, chunk_rounds=r - done), r
        out.append(state.logm.reshape(-1, state.logm.shape[-1]).clone())
    return out


def bitwise(a, b) -> bool:
    """Equal bit for bit, -0.0 against 0.0 included (float32)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_prelude(cases, device, bw):
    """The edge-prelude kernel at the main paths' shapes. For each ``name:
    (pgm, message sets)`` of ``cases``: on every set, one launch whose
    ``pre`` is bitwise ``messages.edge_prelude``'s and the plain twin's;
    on the last set, CUDA-event ms of the kernel, the twin and the torch
    gathers of ``messages.edge_prelude``, the kernel's and the gathers'
    device ms, and the kernel's bound: ``edge_prelude_cost``'s bytes at
    the card's memory rate ``bw``."""
    from repro_torch.core import messages as M
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.roofline.kernel_model import edge_prelude_cost
    out = {}
    for name, (pgm, logms) in cases.items():
        def operands(lm):
            return (lm, pgm.log_psi_v, pgm.state_mask, pgm.in_edges,
                    pgm.in_mask, pgm.edge_src, pgm.edge_rev, pgm.edge_mask)
        for lm in logms:
            before = EP.LAUNCHES["edge_prelude"]
            got = EP.edge_prelude(pgm, lm)
            sync(device)
            launched = EP.LAUNCHES["edge_prelude"] - before
            if launched != (1 if device.type == "cuda" else 0):
                raise AssertionError(f"{name}: {launched} prelude launches "
                                     "for one call")
            if not (bitwise(got, M.edge_prelude(pgm, lm))
                    and bitwise(got, EP.edge_prelude_ref(*operands(lm)))):
                raise AssertionError(f"{name}: the edge-prelude kernel is "
                                     "not bitwise messages.edge_prelude")
        lm = logms[-1]
        (e, s), (v, d) = lm.shape, pgm.in_edges.shape
        cost = edge_prelude_cost(e, v, s, d)

        def kern():
            return EP.edge_prelude(pgm, lm)

        def gathers():
            return M.edge_prelude(pgm, lm)
        row = out[name] = dict(
            E=e, V=v, S=s, D=d, message_sets=len(logms), bytes=cost.bytes,
            bound_ms=cost.bytes / bw * 1e3, ms=time_ms(kern, 50),
            device_ms=device_ms(kern),
            plain_ms=time_ms(lambda: EP.edge_prelude_ref(*operands(lm)), 10),
            torch_ms=time_ms(gathers, 20), torch_device_ms=device_ms(gathers))
        log(f"  edge_prelude {name}: E={e} V={v} S={s} D={d}, bitwise on "
            f"{len(logms)} message sets; kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
            f"({cost.bytes / 1e6:.1f} MB), twin {row['plain_ms']:.4f} ms, "
            f"torch gathers {row['torch_ms']:.4f} ms (device "
            f"{row['torch_device_ms']:.4f})")
    return out


def serving_stream(frames, zoo_n, host):
    """The serving phase's online request stream: the stereo ``frames``
    (host graphs, made beforehand as set-up), each followed by its share of
    ``zoo_stream(zoo_n, seed=0)`` built on ``host`` as it is pulled, the
    rest of the zoo last. ``stereo_rids`` gives the frames' arrival
    positions."""
    from repro_torch.pgm import zoo_stream
    per = zoo_n // len(frames)
    zoo = (p for _, p in zoo_stream(zoo_n, seed=0, device=host))
    for frame in frames:
        yield frame
        for _ in range(per):
            yield next(zoo)
    yield from zoo


def stereo_rids(frames, zoo_n):
    """Arrival positions (auto rids) of the stereo frames in
    ``serving_stream``."""
    return [k * (zoo_n // frames + 1) for k in range(frames)]


def watch_pipeline(engine, capture=False, timed=False):
    """Hooks on one serving run; call the returned ``undo`` after it.
    Always: every backfilled rid (``backfilled``). With ``capture``, per
    bucket shape (E, S), the input state of the last step of the widest
    bucket of that shape (``captured``) -- its graph and messages are what
    the serving path hands the kernels. Only references are kept: nothing
    is copied or synchronized, but the captured buckets outlive their
    slots. With ``timed``: the host seconds inside staging,
    admission, backfill and steps (``seconds``; a step's include its own
    waits on the card, none is added) and, on the card, a CUDA event pair
    around each step on the current stream (``events``)."""
    import torch
    from repro_torch.core.serving import ServingPipeline as P
    w = dict(backfilled=[], captured={}, events=[],
             seconds={"stage": 0.0, "admit": 0.0, "backfill": 0.0,
                      "step": 0.0})
    saved = {name: getattr(P, f"_{name}") for name in (
        ("stage", "admit", "backfill") if timed else ("backfill",))}
    step = engine.step
    cuda = engine.device.type == "cuda"

    def hooked(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            w["seconds"][name] += time.perf_counter() - t0
            if name == "backfill":
                _, _, slot, j = args
                w["backfilled"].append(slot.live[j])
            return out
        return wrapper

    def stepped(state, **kw):
        g = state.graph
        key = (g.n_edges, g.n_states_max)
        have = w["captured"].get(key)
        if capture and (have is None or g.size >= have.graph.size):
            w["captured"][key] = state
        if not timed:
            return step(state, **kw)
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        out = step(state, **kw)
        w["seconds"]["step"] += time.perf_counter() - t0
        if cuda:
            ev[1].record()
            w["events"].append(ev)
        return out

    for name, fn in saved.items():
        setattr(P, f"_{name}", hooked(name, fn))
    engine.step = stepped

    def undo():
        for name, fn in saved.items():
            setattr(P, f"_{name}", fn)
        del engine.step
    return w, undo


def check_captured(captured, kernel):
    """Each captured serving state's kernel operands -- its bucket's union,
    messages and edge prelude, as the ``"pallas"`` (``kernel="t"``) or
    ``"triton"`` (``"e"``) batch backend builds them -- through the kernel
    and its plain version (sum-product, ``SUM_TOL``). Returns one row per
    shape: B, E, S, the largest round count reached, the error."""
    from repro_torch.core import messages as M
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
    from repro_torch.kernels.triton_update import fused_update_e
    rows = []
    for (e, s), state in sorted(captured.items()):
        union = state.graph.folded()
        logm = state.logm.reshape(-1, s)
        pre = M.edge_prelude(union, logm)
        if kernel == "t":
            logpsi_t, dmask_t = union.operands_t
            ops = (logpsi_t, pre.t().contiguous(), logm.t().contiguous(),
                   dmask_t)
            err = compare("sum", fused_update_t(*ops), fused_update_t_ref(*ops))
        else:
            ops = (union.log_psi_e, pre, logm, union.dst_mask)
            err = compare("sum", fused_update_e(*ops), fused_update_e_ref(*ops))
        rows.append(dict(B=state.graph.size, E=e, S=s,
                         rounds=int(state.rounds.max()), max_abs_err=err))
        del ops, pre, logm, union
    return rows


def busy_seconds(prof):
    """Seconds in which the card ran anything (kernels, copies, memsets)
    in a ``torch.profiler`` trace: the union of its device intervals, so
    work overlapping on two streams counts once. Also the event count."""
    from torch.autograd import DeviceType
    spans = [(ev.time_range.start, ev.time_range.end)
             for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    return sum(b - a for a, b in merged(spans)) / 1e6, len(spans)


def backfill_cost(eng, scenes, device):
    """One backfill at the serving path's own shape: four frames staged as
    ``serve_async`` stages them (padded to their ``bucket_shape``),
    admitted into one bucket that steps a round, then a fifth loaded into
    slot 1 (``load_slot``; fewer frames make a narrower bucket), and the rebuild of the bucket's fold and
    transposed table that the next chunk pays. Milliseconds on the host
    clock, the card synchronized around each part."""
    from repro_torch.core.serving import ServingPipeline
    width = min(4, len(scenes) - 1)
    with ServingPipeline(eng, 0, max_batch=width) as pipe:
        for rid, pgm in enumerate(scenes[:width + 1]):
            pipe._stage(rid, pgm, 0.0)
        group, = pipe._groups.values()
        slot = pipe._admit(group)
        state = eng.step(slot.state, chunk_rounds=1)
        state.graph.folded().operands_t
        staged = pipe.policy.take(group, 1)[0]
        elem = pipe._ready(staged)
        sync(device)
        t0 = time.perf_counter()
        state = eng.load_slot(state, min(1, width - 1), elem, staged.key)
        sync(device)
        t1 = time.perf_counter()
        state.graph.folded().operands_t
        sync(device)
        g = state.graph
        return dict(B=g.size, E=g.n_edges, S=g.n_states_max,
                    load_slot=(t1 - t0) * 1e3,
                    fold_rebuild=(time.perf_counter() - t1) * 1e3)


def padded_solo(eng, pgm, rid):
    """A solo run on the engine's device of ``pgm`` padded to its
    ``bucket_shape``, drawing from ``slot_generator(0, rid)``: what the
    online pipeline must reproduce bitwise for request ``rid``."""
    from repro_torch.core import PGM, bucket_shape, slot_generator
    from repro_torch.core.graph import pad_pgm_arrays
    e, v, s, re_, rv = bucket_shape(pgm)
    padded = PGM.from_numpy(
        pad_pgm_arrays(pgm, n_edges=e, n_vertices=v, n_states=s), rv, re_,
        eng.device, edge_count=pgm.edge_count, vertex_count=pgm.vertex_count)
    return eng.run(padded, slot_generator(0, rid, eng.device))


def deadline_run(device, zoo_n, slos):
    """LBP at ``DEADLINE_EPS`` over ``zoo_stream(zoo_n, slos=slos)`` with
    ``admission="deadline"`` and a ``SweepClock``: the record list, the
    timeline (rid, status, t_enqueue, t_admit, t_done, rounds) and the
    states ``watch_pipeline`` captured. ``batch_backend="triton"``: the
    buckets run ``fused_update_e``."""
    from repro_torch.core import BPConfig, BPEngine, SweepClock, serve_async
    from repro_torch.pgm import zoo_stream
    eng = BPEngine(BPConfig(scheduler="lbp", eps=DEADLINE_EPS,
                            max_rounds=ZOO_ROUNDS, backend="pallas",
                            batch_backend="triton"), device=device)
    items = ((None, p, slo) for _, p, slo in
             zoo_stream(zoo_n, seed=0, slos=slos, device=device))
    watch, undo = watch_pipeline(eng, capture=True)
    try:
        rep = serve_async(eng, items, 0, admission="deadline",
                          clock=SweepClock(), chunk_rounds=DEADLINE_CHUNK,
                          **{k: v for k, v in SERVE_KW.items()
                             if k != "ingest_threads"})
    finally:
        undo()
    line = [(r.rid, r.status, r.t_enqueue, r.t_admit, r.t_done,
             int(r.result.rounds)) for r in rep.records]
    return rep, line, watch["captured"]


def serve_once(eng, scenes, zoo_n, device, timed=False):
    """One ``serve_async`` run of ``serving_stream`` with ``SERVE_KW``:
    ``(report, wall seconds, launches by kernel, watch)``, the launch
    counts and the peak-memory counter reset just before. With ``timed``
    the run is traced by ``torch.profiler`` on the card, and timed and
    its chunks captured by ``watch_pipeline``; ``watch["busy"]`` is then
    the card's busy seconds and trace event count."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import serve_async
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    cuda = device.type == "cuda"
    host = torch.device("cpu")
    watch, undo = watch_pipeline(eng, capture=timed, timed=timed)
    trace = (profile(activities=[ProfilerActivity.CUDA])
             if timed and cuda else contextlib.nullcontext())
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    MU.reset_launch_counts()
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    try:
        with trace as prof:
            t0 = time.perf_counter()
            rep = serve_async(eng, serving_stream(scenes, zoo_n, host), 0,
                              **SERVE_KW)
            sync(device)
            wall = time.perf_counter() - t0
    finally:
        undo()
    launches = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                "fused_update_e/sum": TT.LAUNCHES["sum"],
                "fused_update_e/max": TT.LAUNCHES["max"],
                "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    if prof is not None:
        watch["busy"] = busy_seconds(prof)
    return rep, wall, launches, watch


def serve_stats(st):
    return dict(chunks=st.chunks, device_sweeps=st.device_sweeps,
                useful_sweeps=st.useful_sweeps,
                wasted_sweeps=st.wasted_sweeps, evacuated=st.evacuated,
                backfilled=st.backfilled, compactions=st.compactions,
                buckets_opened=st.buckets_opened,
                admission_widths=st.admission_widths)


def phase_serving(device, frames=SERVE_FRAMES, scene=STEREO, zoo_n=SERVE_ZOO,
                  max_rounds=STEREO_ROUNDS, slos=DEADLINE_SLOS):
    """The serving path: ``serve_async`` over an online stream of
    ``frames`` stereo scenes interleaved with the zoo stream (RnBP through
    the ``"pallas"`` backends, ``SERVE_KW``), launch counts reset just
    before and read just after. A first run, traced by the profiler and
    timed part by part, gives the card's busy share and where the host's
    time went, and ``fused_update_t`` is held against its plain version on
    one captured chunk of each bucket shape it stepped. The second run
    carries no timer and no added synchronization: its wall time gives
    requests/s, and on it every rid is released once, stereo beliefs are
    finite and normalized, and the first admitted and the last backfilled
    stereo request are bitwise their padded solo runs. Then ``engine.serve`` against ``run_many`` over
    4 frames (bitwise), the cost of one backfill at the serving shape, and
    the deadline policy under a ``SweepClock`` on the card against the
    CPU's plain path (same timeline and stats, completed beliefs within
    1e-4), with ``fused_update_e`` against its plain version on the
    card run's captured chunks."""
    import torch
    from repro_torch.core import BPEngine
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import stereo_mrf
    cuda = device.type == "cuda"
    host = torch.device("cpu")
    eng = BPEngine(batched_config(max_rounds), device=device)
    rids = stereo_rids(frames, zoo_n)
    t0 = time.perf_counter()
    scenes = [stereo_mrf(scene["height"], scene["width"], scene["n_disp"],
                         seed=k, device=host).pgm for k in range(frames)]
    build_s = time.perf_counter() - t0

    # First the traced and timed run, which also warms the caching
    # allocators (device and pinned host memory) as a serving process
    # would be: the card's busy share, the host's parts, and
    # fused_update_t against its plain version on its captured chunks.
    rep, wall_t, _, watch = serve_once(eng, scenes, zoo_n, device,
                                       timed=True)
    busy, n_events = watch.get("busy", (0.0, 0))
    sync(device)
    kernel_check = {"fused_update_t/sum": check_captured(
        watch.pop("captured"), "t")}
    traced = dict(
        wall_s=wall_t, requests=len(rep.records),
        stats=serve_stats(rep.stats), host_seconds=watch["seconds"],
        step_device_s=sum(a.elapsed_time(b) for a, b in watch["events"])
        / 1e3, busy_s=busy, device_events=n_events,
        idle_share=1.0 - busy / wall_t)
    del rep, watch

    # The measured run: no timer, no added synchronization.
    rep, wall, launches, watch = serve_once(eng, scenes, zoo_n, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n = frames + zoo_n
    got = sorted(r.rid for r in rep.records)
    if got != list(range(n)):
        raise AssertionError(f"released rids {got}, expected 0..{n - 1} "
                             "once each")
    if launches["fused_update_t/sum"] < rep.stats.chunks:
        raise AssertionError("the serving path bypassed fused_update_t")
    backfilled = watch["backfilled"]
    by_rid = {r.rid: r for r in rep.records}
    stereo = [r for r in rep.records if r.rid in rids]
    first = min(stereo, key=lambda r: (r.t_admit, r.rid)).rid
    late = [rid for rid in backfilled if rid in rids]
    last = late[-1] if late else max(stereo, key=lambda r: r.t_admit).rid
    checked = {}
    for rid in sorted({first, last}):
        pgm = scenes[rids.index(rid)]
        check_beliefs(pgm, by_rid[rid].result, padded=True)
        solo = padded_solo(eng, pgm, rid)
        if not same_result(solo, by_rid[rid].result):
            raise AssertionError(f"stereo request {rid} differs from its "
                                 "padded solo run")
        checked[rid] = "backfilled" if rid in backfilled else "admitted"
    frames_out = []
    for k, rid in enumerate(rids):
        res = by_rid[rid].result
        check_beliefs(scenes[k], res, padded=True)
        frames_out.append(dict(rid=rid, rounds=int(res.rounds),
                               converged=bool(res.converged),
                               t_admit=by_rid[rid].t_admit,
                               latency_s=by_rid[rid].latency_s))
    pct = {f: rep.latency_percentiles((50, 90, 99), field=f,
                                      status="completed")
           for f in ("latency", "admission", "service")}
    out = dict(requests=n, frames_build_s=build_s, wall_s=wall,
               requests_per_s=n / wall, latency_ms=pct,
               stats=serve_stats(rep.stats), launches=launches,
               peak_memory_bytes=peak, frames=frames_out,
               bitwise_solo=checked, kernel_check=kernel_check,
               traced=traced, host_seconds=traced["host_seconds"])
    del rep, stereo, by_rid

    out["traced"]["busy_over_untraced_wall"] = out["traced"]["busy_s"] / wall
    out["backfill_ms"] = backfill_cost(eng, scenes, device)
    del scenes

    # engine.serve == run_many over 4 frames (one same-shape group).
    pgms = [stereo_mrf(scene["height"], scene["width"], scene["n_disp"],
                       seed=k, device=device).pgm for k in range(4)]
    served = eng.serve(pgms, 0).results
    many = eng.run_many(pgms, 0)
    for k, (a, b) in enumerate(zip(served, many)):
        if not same_result(a, b):
            raise AssertionError(f"engine.serve differs from run_many on "
                                 f"frame {k}")
    out["serve_equals_run_many"] = [int(r.rounds) for r in served]
    del served, many, pgms

    # The deadline policy on the card and on the CPU's plain path.
    MU.reset_launch_counts()
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    card, line, captured = deadline_run(device, zoo_n, slos)
    for k, v in (("fused_update_t/sum", MU.LAUNCHES["sum"]),
                 ("fused_update_e/sum", TT.LAUNCHES["sum"]),
                 ("fused_update_e/max", TT.LAUNCHES["max"]),
                 ("edge_prelude", EP.LAUNCHES["edge_prelude"])):
        launches[k] += v
    if TT.LAUNCHES["sum"] < card.stats.chunks:
        raise AssertionError("the deadline run bypassed fused_update_e")
    kernel_check["fused_update_e/sum"] = check_captured(captured, "e")
    del captured
    cpu, cpu_line, _ = deadline_run(host, zoo_n, slos)
    if line != cpu_line:
        raise AssertionError(f"deadline timeline on the card {line} differs "
                             f"from the CPU's {cpu_line}")
    if dataclasses.asdict(card.stats) != dataclasses.asdict(cpu.stats):
        raise AssertionError(f"deadline stats on the card {card.stats} "
                             f"differ from the CPU's {cpu.stats}")
    mid = [r for r in card.records if r.evicted and int(r.result.rounds) > 0]
    if not mid:
        raise AssertionError("no request was evicted mid-flight")
    worst = 0.0
    for a, b in zip(card.records, cpu.records):
        if a.status == "completed":
            worst = max(worst, float((a.result.beliefs.cpu().exp()
                                      - b.result.beliefs.exp()).abs().max()))
    if not worst <= 1e-4:
        raise AssertionError(f"deadline beliefs differ by {worst} > 1e-4")
    out["deadline"] = dict(
        requests=len(line), evictions=card.stats.evictions,
        midflight=[(r.rid, r.t_done, int(r.result.rounds)) for r in mid],
        chunks=card.stats.chunks, device_sweeps=card.stats.device_sweeps,
        max_prob_diff=worst, timeline_equal=True, stats_equal=True)
    return out


def merged(spans):
    """The union of ``(start, end)`` intervals, as sorted disjoint
    ``[start, end]`` pairs."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(x, y) -> float:
    """Length of the intersection of two unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if hi > lo:
            total += hi - lo
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def kernel_streams(prof, path):
    """Per CUDA stream, the union of its kernels' device intervals (us),
    from the trace's Chrome export (written to ``path``, then removed)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    spans = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "kernel":
            stream = ev.get("args", {}).get("stream", ev.get("tid"))
            spans.setdefault(stream, []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    return {k: merged(v) for k, v in spans.items()}


def route_once(engines, stream, device, *, routing, steal, traced=False,
               **kw):
    """One ``serve_routed`` run over ``engines`` (one per replica):
    ``(result, wall seconds, launches by kernel, peak bytes, trace,
    captured states, routing seconds)``, launch counts and the
    peak-memory counter reset just before. With ``traced`` the run is
    traced by ``torch.profiler`` on the card, each engine's chunks are
    captured by ``watch_pipeline``, and the router thread's seconds in
    ``Router.loads`` and ``Replica.submit`` are summed."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.serve import serve_routed
    from repro_torch.serve.replica import Replica
    from repro_torch.serve.router import Router
    cuda = device.type == "cuda"
    hooks = [watch_pipeline(e, capture=True) for e in engines] \
        if traced else []
    routing_s = [0.0]
    saved = (Router.loads, Replica.submit)

    def timed(fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            routing_s[0] += time.perf_counter() - t0
            return out
        return wrapper
    if traced:          # the router thread's placement work
        Router.loads, Replica.submit = map(timed, saved)
    trace = (profile(activities=[ProfilerActivity.CUDA])
             if traced and cuda else contextlib.nullcontext())
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    MU.reset_launch_counts()
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    try:
        with trace as prof:
            t0 = time.perf_counter()
            rep = serve_routed(engines, stream, 0, routing=routing,
                               steal=steal, **kw)
            sync(device)
            wall = time.perf_counter() - t0
    finally:
        Router.loads, Replica.submit = saved
        for _, undo in reversed(hooks):
            undo()
    launches = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                "fused_update_e/sum": TT.LAUNCHES["sum"],
                "fused_update_e/max": TT.LAUNCHES["max"],
                "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    captured = {}
    for w, _ in hooks:
        for key, state in w["captured"].items():
            have = captured.get(key)
            if have is None or state.graph.size >= have.graph.size:
                captured[key] = state
    return rep, wall, launches, peak, prof, captured, routing_s[0]


def routed_numbers(rep, wall, peak):
    """What each router run reports beside phase 14's single pipeline;
    ``inbox_wait_ms``: a request's wait between the router's pull and its
    replica's (``t_enqueue - t_route``), p50/p99."""
    import numpy as np
    wait = np.array([r.record.t_enqueue - r.t_route
                     for r in rep.records]) * 1e3
    return dict(
        inbox_wait_ms={"p50": float(np.percentile(wait, 50)),
                       "p99": float(np.percentile(wait, 99))},
        requests=len(rep.records), wall_s=wall,
        requests_per_s=len(rep.records) / wall,
        latency_ms={f: rep.latency_percentiles((50, 90, 99), field=f,
                                               status="completed")
                    for f in ("latency", "admission", "service")},
        device_sweeps=rep.device_sweeps, useful_sweeps=rep.useful_sweeps,
        wasted_sweeps=rep.wasted_sweeps, routed=list(rep.stats.routed),
        steals=rep.stats.steals, stolen=rep.stats.stolen,
        peak_memory_bytes=peak)


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def router_deadline_run(device, zoo_n):
    """LBP at ``DEADLINE_EPS`` through ``serve_routed`` with
    ``admission="deadline"``, ``routing="deadline"`` and one shared
    ``SweepClock``: ``zoo_stream(zoo_n)`` without budgets, and the
    ``ROUTER_IMPOSSIBLE`` 6 x 6 Ising grids with ``ROUTER_SLO``, all built
    on ``device`` as the router pulls them. ``batch_backend="triton"``:
    the buckets run ``fused_update_e``. Returns the result, the launches,
    the captured states and the impossible rids."""
    from repro_torch.core import BPConfig, BPEngine, SweepClock
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import ising_grid, zoo_stream
    from repro_torch.serve import serve_routed
    cfg = BPConfig(scheduler="lbp", eps=DEADLINE_EPS, max_rounds=ZOO_ROUNDS,
                   backend="pallas", batch_backend="triton")
    engines = [BPEngine(cfg, device=device) for _ in range(ROUTER_REPLICAS)]
    step = max(1, zoo_n // len(ROUTER_IMPOSSIBLE))
    at = {k * step: seed for k, seed in enumerate(ROUTER_IMPOSSIBLE)}

    def items():
        for i, (_, pgm) in enumerate(zoo_stream(zoo_n, seed=0,
                                                device=device)):
            if i in at:
                yield None, ising_grid(6, 3.5, seed=at[i], device=device), \
                    ROUTER_SLO
            yield None, pgm, None
    impossible = [k + i for i, k in enumerate(sorted(at))]
    hooks = [watch_pipeline(e, capture=True) for e in engines]
    MU.reset_launch_counts()
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    try:
        rep = serve_routed(engines, items(), 0, routing="deadline",
                           admission="deadline", clock=SweepClock(),
                           chunk_rounds=DEADLINE_CHUNK, **ROUTER_KW)
    finally:
        for _, undo in reversed(hooks):
            undo()
    launches = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                "fused_update_e/sum": TT.LAUNCHES["sum"],
                "fused_update_e/max": TT.LAUNCHES["max"],
                "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    captured = {}
    for w, _ in hooks:
        captured.update(w["captured"])
    return rep, launches, captured, impossible


def skew_run(device, steal, fast_n=SKEW_FAST, hold_s=SKEW_HOLD_S):
    """The skewed-stealing scenario of ``benchmarks/bench_router.py``:
    replica 0 gets a straggler (6 x 6 Ising, C = 3.5) and one fast grid
    (C = 1.5), replica 1 the ``fast_n`` more; the stream stays open
    ``hold_s`` after its last request. LBP through ``"triton"``, graphs
    built on ``device``. ``(result, launches)``."""
    from repro_torch.core import BPConfig, BPEngine
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import ising_grid
    from repro_torch.serve import RoutingPolicy, serve_routed

    class Skew(RoutingPolicy):
        name = "skew"

        def pick(self, rid, kind, loads):
            return 0 if rid < 2 else 1

    cfg = BPConfig(scheduler="lbp", eps=SKEW_EPS, max_rounds=SKEW_ROUNDS,
                   history=False, backend="triton")
    engines = [BPEngine(cfg, device=device) for _ in range(ROUTER_REPLICAS)]
    fast = ising_grid(6, 1.5, seed=0, device=device)
    stream = [ising_grid(6, 3.5, seed=100, device=device), fast] + \
        [fast] * fast_n

    def held():
        yield from stream
        time.sleep(hold_s)
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    rep = serve_routed(engines, held(), 0, routing=Skew(), steal=steal,
                       **SKEW_KW)
    return rep, {"fused_update_e/sum": TT.LAUNCHES["sum"],
                 "edge_prelude": EP.LAUNCHES["edge_prelude"]}


def phase_router(device, frames=SERVE_FRAMES, scene=STEREO, zoo_n=SERVE_ZOO,
                 max_rounds=STEREO_ROUNDS, skew_fast=SKEW_FAST,
                 skew_hold=SKEW_HOLD_S):
    """The router tier: phase 14's online stream through ``serve_routed``
    with ``ROUTER_REPLICAS`` replicas, each on a CUDA stream of its own.
    First a traced run (round robin, no stealing; it also warms the
    allocators) for the card's busy seconds, the CUDA streams the kernels
    ran on and the replicas' overlap, and ``fused_update_t`` against its
    plain version on one captured chunk of every bucket shape served. Then
    two untimed-inside runs: (a) round robin without stealing, every
    record bitwise the ``serve_async`` run of its replica's share alone;
    (b) least-loaded with stealing, every result bitwise run (a)'s. Then
    the SLA check on card and CPU, and the skewed-stealing scenario with
    stealing off and on."""
    import torch
    from repro_torch.core import BPEngine, serve_async
    from repro_torch.pgm import stereo_mrf
    host = torch.device("cpu")
    scenes = [stereo_mrf(scene["height"], scene["width"], scene["n_disp"],
                         seed=k, device=host).pgm for k in range(frames)]
    engines = [BPEngine(batched_config(max_rounds), device=device)
               for _ in range(ROUTER_REPLICAS)]
    n = frames + zoo_n
    launches = {}

    rep, wall_t, _, _, prof, captured, routing_s = route_once(
        engines, serving_stream(scenes, zoo_n, host), device,
        routing="round_robin", steal=False, traced=True, **ROUTER_KW)
    traced = dict(wall_s=wall_t, requests=len(rep.records), busy_s=0.0,
                  idle_share=1.0, kernel_streams=0, overlap_s=0.0,
                  stream_busy_s=[], routing_s=routing_s)
    if prof is not None:
        busy, n_events = busy_seconds(prof)
        streams = kernel_streams(prof, REPO / "chiprun_out" /
                                 "router_trace.json")
        busiest = sorted(streams.values(), key=lambda u: -sum(
            b - a for a, b in u))
        traced.update(
            busy_s=busy, device_events=n_events, idle_share=1.0 - busy / wall_t,
            kernel_streams=len(streams),
            stream_busy_s=[sum(b - a for a, b in u) / 1e6 for u in busiest],
            overlap_s=(overlap(busiest[0], busiest[1]) / 1e6
                       if len(busiest) > 1 else 0.0))
        if traced["kernel_streams"] < ROUTER_REPLICAS:
            raise AssertionError(f"kernels ran on {len(streams)} CUDA "
                                 "stream(s): the replicas shared one")
    kernel_check = {"fused_update_t/sum": check_captured(captured, "t")}
    del rep, prof, captured

    # (a) round robin, no stealing: bitwise each share's solo serve_async.
    rep_a, wall, got, peak = route_once(
        engines, serving_stream(scenes, zoo_n, host), device,
        routing="round_robin", steal=False, **ROUTER_KW)[:4]
    add_launches(launches, got)
    if got["fused_update_t/sum"] < sum(
            s.chunks for s in rep_a.replica_stats):
        raise AssertionError("the routed path bypassed fused_update_t")
    by_rid = {r.rid: r for r in rep_a.records}
    if sorted(by_rid) != list(range(n)):
        raise AssertionError(f"released rids {sorted(by_rid)}, expected "
                             f"0..{n - 1} once each")
    if rep_a.stats.routed != [n // ROUTER_REPLICAS + (k < n % ROUTER_REPLICAS)
                              for k in range(ROUTER_REPLICAS)]:
        raise AssertionError(f"round robin routed {rep_a.stats.routed}")
    rids = stereo_rids(frames, zoo_n)
    for k, rid in enumerate(rids):
        check_beliefs(scenes[k], by_rid[rid].result, padded=True)
    items = list(enumerate(serving_stream(scenes, zoo_n, host)))
    for k in range(ROUTER_REPLICAS):
        share = [it for it in items if it[0] % ROUTER_REPLICAS == k]
        solo = serve_async(engines[0], iter(share), 0, **ROUTER_KW)
        for rec in solo.records:
            if not same_result(rec.result, by_rid[rec.rid].result):
                raise AssertionError(f"routed request {rec.rid} differs from "
                                     f"its share's solo serve_async run")
    del items, solo
    run_a = routed_numbers(rep_a, wall, peak)

    # (b) least-loaded with stealing: bitwise run (a), rid by rid.
    rep_b, wall, got, peak = route_once(
        engines, serving_stream(scenes, zoo_n, host), device,
        routing="least_loaded", steal=True, **ROUTER_KW)[:4]
    for r in rep_b.records:
        if not same_result(r.result, by_rid[r.rid].result):
            raise AssertionError(f"request {r.rid} under least_loaded with "
                                 "stealing differs from round robin")
    if len(rep_b.records) != n:
        raise AssertionError(f"{len(rep_b.records)} records, expected {n}")
    run_b = routed_numbers(rep_b, wall, peak)
    del rep_a, rep_b, by_rid, scenes

    # The SLA check: card against the CPU's plain path.
    card, got, captured, impossible = router_deadline_run(device, zoo_n)
    add_launches(launches, got)
    if got["fused_update_e/sum"] < sum(s.chunks for s in card.replica_stats):
        raise AssertionError("the routed deadline run bypassed fused_update_e")
    kernel_check["fused_update_e/sum"] = check_captured(captured, "e")
    del captured
    cpu = router_deadline_run(host, zoo_n)[0]
    status = {r.rid: r.status for r in card.records}
    if status != {r.rid: r.status for r in cpu.records}:
        raise AssertionError("routed deadline statuses differ between the "
                             "card and the CPU")
    evicted = sorted(rid for rid, st in status.items() if st == "evicted")
    if evicted != impossible:
        raise AssertionError(f"evicted {evicted}, expected {impossible}")
    cpu_by = {r.rid: r.result for r in cpu.records}
    worst = 0.0
    for r in card.records:
        if r.status == "completed":
            b = cpu_by[r.rid]
            if int(r.result.rounds) != int(b.rounds):
                raise AssertionError(f"routed deadline rid {r.rid}: rounds "
                                     f"{int(r.result.rounds)} on the card, "
                                     f"{int(b.rounds)} on the CPU")
            worst = max(worst, float((r.result.beliefs.cpu().exp()
                                      - b.beliefs.exp()).abs().max()))
    if not worst <= 1e-5:
        raise AssertionError(f"routed deadline beliefs differ by {worst}")
    deadline = dict(requests=len(status), evicted=evicted,
                    routed=list(card.stats.routed), max_prob_diff=worst,
                    statuses_equal=True)
    del card, cpu, cpu_by

    # Skewed stealing: fewer wasted sweeps with it on, the same results.
    skew = {}
    for steal in (False, True):
        rep, got = skew_run(device, steal, skew_fast, skew_hold)
        add_launches(launches, got)
        skew[steal] = (rep, [r.logm.cpu().numpy().tobytes()
                             for r in rep.results])
    (off, fp_off), (on, fp_on) = skew[False], skew[True]
    if fp_on != fp_off:
        raise AssertionError("stealing changed a result bit")
    if not (on.stats.stolen > 0 and on.wasted_sweeps < off.wasted_sweeps):
        raise AssertionError(f"stealing: wasted sweeps {on.wasted_sweeps} "
                             f"on vs {off.wasted_sweeps} off, stolen "
                             f"{on.stats.stolen}")
    stealing = {mode: dict(wasted_sweeps=r.wasted_sweeps,
                           useful_sweeps=r.useful_sweeps,
                           device_sweeps=r.device_sweeps,
                           steals=r.stats.steals, stolen=r.stats.stolen)
                for mode, r in (("off", off), ("on", on))}
    stealing["bitwise_on_vs_off"] = True
    return dict(requests=n, replicas=ROUTER_REPLICAS, traced=traced,
                round_robin=run_a, least_loaded_steal=run_b,
                kernel_check=kernel_check, deadline=deadline,
                stealing=stealing, launches=launches,
                bitwise=dict(round_robin_vs_solo_shares=True,
                             least_loaded_steal_vs_round_robin=True))


def log_router(out, serving) -> None:
    """Phase 15's progress lines, phase 14's single pipeline beside."""
    def row(label, r):
        lat = r["latency_ms"]
        log(f"  {label}: {r['requests']} requests in {r['wall_s']:.3f} s = "
            f"{r['requests_per_s']:.2f} requests/s; completed latency "
            f"p50/p90/p99 {lat['latency']['p50']:.1f}/"
            f"{lat['latency']['p90']:.1f}/{lat['latency']['p99']:.1f} ms "
            f"(admission {lat['admission']['p50']:.1f}/"
            f"{lat['admission']['p90']:.1f}/{lat['admission']['p99']:.1f}, "
            f"service {lat['service']['p50']:.1f}/"
            f"{lat['service']['p90']:.1f}/{lat['service']['p99']:.1f}; "
            f"inbox wait p50/p99 {r['inbox_wait_ms']['p50']:.1f}/"
            f"{r['inbox_wait_ms']['p99']:.1f}); "
            f"wasted sweeps {r['wasted_sweeps']} of {r['device_sweeps']}; "
            f"routed {r['routed']}; steals {r['steals']} ({r['stolen']} "
            f"requests); peak memory {r['peak_memory_bytes'] / 2**30:.2f} GiB")
    st = serving["stats"]
    row("phase 14, one pipeline", dict(
        inbox_wait_ms={"p50": 0.0, "p99": 0.0},
        requests=serving["requests"], wall_s=serving["wall_s"],
        requests_per_s=serving["requests_per_s"],
        latency_ms=serving["latency_ms"], wasted_sweeps=st["wasted_sweeps"],
        device_sweeps=st["device_sweeps"], routed=[serving["requests"]],
        steals=0, stolen=0, peak_memory_bytes=serving["peak_memory_bytes"]))
    row("(a) round_robin, no stealing", out["round_robin"])
    row("(b) least_loaded, stealing", out["least_loaded_steal"])
    tr = out["traced"]
    log(f"  traced run (a): {tr['requests']} requests in {tr['wall_s']:.3f} "
        f"s; card busy {tr['busy_s']:.3f} s = idle share "
        f"{tr['idle_share']:.3f}; kernels on {tr['kernel_streams']} CUDA "
        f"streams, busy {[round(x, 3) for x in tr['stream_busy_s']]} s; "
        f"the two replicas' kernels overlap {tr['overlap_s']:.3f} s; "
        f"router thread's placement (loads + submit) {tr['routing_s']:.4f} "
        f"s; phase 14's traced run: busy {serving['traced']['busy_s']:.3f} "
        "s")
    log("  bitwise: every record of (a) == its share's solo serve_async; "
        "every result of (b) == (a)'s")
    for name, rows in out["kernel_check"].items():
        for r in rows:
            log(f"  {name} vs plain on a routed chunk: B={r['B']} E={r['E']} "
                f"S={r['S']} rounds={r['rounds']} max_abs_err="
                f"{r['max_abs_err']:.3g}")
    d = out["deadline"]
    log(f"  routed deadline/SweepClock LBP: {d['requests']} requests, routed "
        f"{d['routed']}, evicted {d['evicted']} (the budgeted grids that "
        f"never converge); statuses equal on card and CPU, completed "
        f"beliefs within {d['max_prob_diff']:.3g}")
    sk = out["stealing"]
    log(f"  skewed stealing: wasted sweeps {sk['off']['wasted_sweeps']} off "
        f"-> {sk['on']['wasted_sweeps']} on ({sk['on']['steals']} steals, "
        f"{sk['on']['stolen']} requests); results bitwise equal")
    log(f"  kernel launches on the routed path: {out['launches']}")


def chain_model(n=12, states=3, seed=0):
    """A chain of ``n`` vertices with random positive potentials: BP is
    exact on it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    edges = np.array([(i, i + 1) for i in range(n - 1)])
    return (n, edges, rng.uniform(0.5, 2.0, (n, states)),
            rng.uniform(0.2, 2.0, (n - 1, states, states)))


def phase_resilient(device, pgm, res, paper, ckpt_dir,
                    chunk=RESILIENT_CHUNK, srbp_n=PAPER_N,
                    srbp_limit=SRBP_LIMIT_S):
    """``run_bp_resilient`` on the main path's graph (RnBP, ``"triton"``,
    ``chunk`` rounds a chunk, checkpoints in ``ckpt_dir``) against phase
    4's engine run ``res``, bitwise; then a second call from a mid-run
    checkpoint after the later ones are deleted, bitwise too, and
    ``fused_update_e`` against its plain version on the operands of the
    run's last messages. Then SRBP on Ising ``srbp_n`` x ``srbp_n`` (C =
    2.5) with ``srbp_limit`` seconds, beside phase 5's RnBP on the card,
    and ``kl_divergence`` of the card's RnBP beliefs on a chain against
    ``ve_marginals``."""
    import os
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import BPConfig, BPEngine, build_pgm_uniform
    from repro_torch.core import messages as M
    from repro_torch.core.exact import kl_divergence, ve_marginals
    from repro_torch.core.schedulers import RnBP
    from repro_torch.ft import resilience as RES
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import triton_update as TT
    from repro_torch.kernels.ref import fused_update_e_ref
    from repro_torch.pgm import ising_grid_fast

    def resilient(seed):
        return RES.run_bp_resilient(
            pgm, RnBP(**MAIN_KW), torch.Generator(device=device).manual_seed(
                seed), eps=1e-3, max_rounds=2000, rounds_per_chunk=chunk,
            ckpt_dir=ckpt_dir, backend="triton", device=device)

    def same(a, b, rounds):
        return torch.equal(a.logm, b.logm) and \
            torch.equal(a.beliefs, b.beliefs) and int(a.rounds) == rounds

    save_s = [0.0]
    real_save = RES.save_pytree

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        out = real_save(*args, **kw)
        save_s[0] += time.perf_counter() - t0
        return out
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    total = int(res.rounds)
    try:
        RES.save_pytree = timed_save
        TT.reset_launch_counts()
        EP.reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        got = resilient(0)
        sync(device)
        loop_s = time.perf_counter() - t0
        launches = dict(TT.LAUNCHES, prelude=EP.LAUNCHES["edge_prelude"])
        RES.save_pytree = real_save
        if not same(got, res, total):
            raise AssertionError("the resilient run differs from phase 4's "
                                 "engine run")
        if launches["sum"] < total:
            raise AssertionError("the resilient run bypassed fused_update_e")
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir))
        mid = steps[len(steps) // 2]
        for step in steps:
            if step > mid:
                shutil.rmtree(os.path.join(ckpt_dir, f"step_{step:09d}"))
        resumed = resilient(1)          # the generator comes from the file
        if not same(resumed, res, total - mid):
            raise AssertionError(f"the run resumed at round {mid} differs "
                                 "from phase 4's engine run")
    finally:
        RES.save_pytree = real_save
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ops = (pgm.log_psi_e, M.edge_prelude(pgm, got.logm), got.logm,
           pgm.dst_mask)
    err = compare("sum", TT.fused_update_e(*ops), fused_update_e_ref(*ops))
    del ops, resumed
    resil = dict(rounds=total, chunk=chunk, checkpoints=len(steps),
                 resumed_from=mid, loop_s=loop_s, save_s=save_s[0],
                 launches=launches, max_abs_err=err, bitwise=True)

    big = ising_grid_fast(srbp_n, 2.5, seed=0, device=device)
    t0 = time.perf_counter()
    srbp = BPEngine(BPConfig(scheduler="srbp", eps=1e-3, scheduler_kwargs={
        "time_limit_s": srbp_limit}), device=device).run(big)
    call_s = time.perf_counter() - t0
    if not np.isfinite(srbp.beliefs[:big.n_real_vertices]).all():
        raise AssertionError("non-finite SRBP beliefs")
    rnbp = next(r for r in paper if r["graph"] == f"ising{srbp_n}"
                and r["scheduler"] == "rnbp")
    serial = dict(graph=f"ising_grid_fast({srbp_n}, 2.5)",
                  edges=big.n_real_edges, updates=srbp.updates,
                  updates_per_s=srbp.updates / max(srbp.wall_time_s, 1e-9),
                  converged=srbp.converged, max_residual=srbp.max_residual,
                  wall_s=srbp.wall_time_s, call_s=call_s,
                  rnbp_card=dict(rounds=rnbp["rounds"],
                                 converged=rnbp["converged"],
                                 run_s=rnbp["run_s"]))
    del big

    n, edges, unary, pairwise = chain_model()
    chain = build_pgm_uniform(n, edges, unary, pairwise, device=device)
    out = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs=MAIN_KW,
                            eps=1e-5, backend="triton"), device=device).run(
        chain, torch.Generator(device=device).manual_seed(0))
    exact = ve_marginals(n, edges, list(unary), list(pairwise))
    bp = out.beliefs[:n, :unary.shape[1]].exp().cpu().numpy()
    kl = max(kl_divergence(exact[v], bp[v]) for v in range(n))
    if not (bool(out.converged) and kl <= KL_BOUND):
        raise AssertionError(f"chain RnBP vs exact: KL {kl} > {KL_BOUND}")
    return dict(resilient=resil, srbp=serial,
                kl=dict(graph=f"chain({n}, {unary.shape[1]} states)",
                        rounds=int(out.rounds), max_kl=kl, bound=KL_BOUND))


def log_resilient(out) -> None:
    """Phase 16's progress lines."""
    r = out["resilient"]
    log(f"  run_bp_resilient: {r['rounds']} rounds in chunks of "
        f"{r['chunk']}, {r['checkpoints']} checkpoints, bitwise phase 4's "
        f"run; resumed from round {r['resumed_from']} bitwise too; "
        f"{r['loop_s']:.3f} s in the loop, of which {r['save_s']:.3f} s "
        f"writing checkpoints; fused_update_e launches {r['launches']}, "
        f"vs plain on the last messages {r['max_abs_err']:.3g}")
    s = out["srbp"]
    log(f"  SRBP (host) on {s['graph']}: {s['updates']} updates in "
        f"{s['wall_s']:.3f} s = {s['updates_per_s']:.0f} updates/s, "
        f"converged={s['converged']} (max residual {s['max_residual']:.3g}; "
        f"{s['call_s']:.3f} s with the heap's set-up); RnBP on the card "
        f"(phase 5): {s['rnbp_card']['rounds']} rounds, converged="
        f"{s['rnbp_card']['converged']}, {s['rnbp_card']['run_s']:.3f} s")
    k = out["kl"]
    log(f"  {k['graph']} RnBP on the card vs variable elimination: max KL "
        f"{k['max_kl']:.3g} <= {k['bound']:g} ({k['rounds']} rounds)")


def one_device_backend(device) -> str:
    """The one-device backend whose update the multi-device paths run on
    ``device``: the kernel backend on the card, the plain one on the CPU
    (``repro_torch.dist.slice_update``)."""
    return "triton" if device.type == "cuda" else "ref"


class world:
    """``with world(backend, store, size, rank):`` -- a ``torch.distributed``
    process group from a ``FileStore`` at ``store`` (a stale file removed
    by rank 0), with a ``DIST_TIMEOUT_S`` timeout, destroyed on exit."""

    def __init__(self, backend, store, size=1, rank=0):
        self.args = (backend, Path(store), size, rank)

    def __enter__(self):
        import datetime
        import torch.distributed as dist
        backend, store, size, rank = self.args
        store.parent.mkdir(parents=True, exist_ok=True)
        if rank == 0 and size == 1 and store.exists():
            store.unlink()
        dist.init_process_group(
            backend, store=dist.FileStore(str(store), size), rank=rank,
            world_size=size,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False


def watch_dist(timed=False, host=False):
    """Hooks on the multi-device paths; call the returned ``undo`` after.
    Always: the operands of the last ``slice_update`` call (``captured``;
    references only). With ``timed`` on the card: a CUDA event pair on
    the current stream around every collective the sharded path issues --
    the residuals' gather, the chain fold's passes and broadcast
    (``events``: (name, start, end)) -- whose sum is the collectives'
    device time, waits included. With ``host``: the host seconds spent in
    each collective by name (``host_s``), the card synchronized first so
    that the collective's own staging waits for no earlier kernel."""
    import torch
    from repro_torch import dist as D
    w = dict(captured=None, events=[], host_s={})
    names = ("all_gather_into", "broadcast", "exchange")
    saved = {name: getattr(D.comm, name) for name in names}
    saved_slice = D.slice_update

    def captured(*args):
        w["captured"] = args
        return saved_slice(*args)

    def evented(name, fn):
        def wrapper(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            w["events"].append((name,) + ev)
            return out
        return wrapper

    def clocked(name, fn):
        def wrapper(*args, **kw):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            w["host_s"][name] = w["host_s"].get(name, 0.0) \
                + time.perf_counter() - t0
            return out
        return wrapper

    D.slice_update = captured
    for name in names:
        if timed:
            setattr(D.comm, name, evented(name, saved[name]))
        elif host:
            setattr(D.comm, name, clocked(name, saved[name]))

    def undo():
        D.slice_update = saved_slice
        for name in names:
            setattr(D.comm, name, saved[name])
    return w, undo


def check_slice(args):
    """A captured rank-slice call's operands through ``fused_update_e``
    and its plain version (sum-product, ``SUM_TOL``)."""
    from repro_torch.kernels.ref import fused_update_e_ref
    from repro_torch.kernels.triton_update import fused_update_e
    psi, pre, logm, dmask, _ = args
    ops = (psi, pre, logm, dmask)
    return dict(E=int(logm.shape[0]), S=int(logm.shape[1]),
                max_abs_err=compare("sum", fused_update_e(*ops),
                                    fused_update_e_ref(*ops)))


def phase_dist_one(device, pgm, res, store, backend="nccl",
                   banded_rounds=DIST_BANDED_ROUNDS):
    """Phase 17 (a): a world of one rank over ``backend``. ``run_bp_sharded``
    with the main path's RnBP on ``pgm`` must be bitwise ``res`` (phase 4's
    one-device run: rounds, messages, beliefs); then banded LBP at n = 1,
    capped at ``banded_rounds``, bitwise a one-device LBP run at that cap.
    Launch counts reset just before each path and read just after; a first
    run with hooks (captured slice, collectives' CUDA events: the
    residuals' gather each round; a world of one has no chain pass and no
    broadcast), a second for the wall time."""
    import torch
    from repro_torch import dist as D
    from repro_torch.core.schedulers import RnBP
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import triton_update as TT
    cuda = device.type == "cuda"
    out = {}
    with world(backend, store):
        mesh = D.make_bp_mesh(device=device)
        group = D.mesh_axis(mesh)[2]
        out["transport"] = D.comm.transport(group, device)

        def sharded():
            return D.run_bp_sharded(
                pgm, RnBP(**MAIN_KW), mesh,
                torch.Generator(device=device).manual_seed(0), eps=1e-3,
                max_rounds=2000, device=device)
        w, undo = watch_dist(timed=cuda)
        try:
            TT.reset_launch_counts()
            EP.reset_launch_counts()
            D.comm.reset_stats()
            got = sharded()
            sync(device)
            launches = TT.LAUNCHES["sum"]
            prelude = EP.LAUNCHES["edge_prelude"]
            stats = dict(D.comm.STATS)
        finally:
            undo()
        rounds = int(got.rounds)
        if not (rounds == int(res.rounds) and torch.equal(got.logm, res.logm)
                and torch.equal(got.beliefs, res.beliefs)):
            raise AssertionError(
                f"the sharded world of one differs from the one-device run: "
                f"rounds {rounds} vs {int(res.rounds)}")
        if launches < rounds:
            raise AssertionError(f"sharded: {launches} fused_update_e "
                                 f"launches < {rounds} rounds")
        by_name = {}
        for name, a, b in w["events"]:
            by_name[name] = by_name.get(name, 0.0) + a.elapsed_time(b)
        coll_ms = sum(by_name.values())
        sync(device)
        t0 = time.perf_counter()
        sharded()
        sync(device)
        secs = time.perf_counter() - t0
        out["sharded"] = dict(
            rounds=rounds, launches=launches, prelude_launches=prelude,
            run_s=secs, ms_per_round=secs * 1e3 / max(rounds, 1),
            collectives=stats["collectives"],
            collective_ms_per_round=coll_ms / max(rounds, 1),
            collective_ms_by_name={k: v / max(rounds, 1)
                                   for k, v in by_name.items()},
            staged_bytes=stats["staged_bytes"], bitwise=True,
            kernel_check=check_slice(w["captured"]))

        t0 = time.perf_counter()
        part = D.partition_banded(pgm, 1)
        part_s = time.perf_counter() - t0
        one, _ = run_engine(pgm, device, scheduler="lbp", eps=1e-3,
                            max_rounds=banded_rounds,
                            backend=one_device_backend(device))
        w, undo = watch_dist()
        band_s = [0.0]
        real_band = D.bp_banded._band

        def timed_band(*args):
            t = time.perf_counter()
            out_band = real_band(*args)
            sync(device)
            band_s[0] += time.perf_counter() - t
            return out_band
        try:
            D.bp_banded._band = timed_band
            TT.reset_launch_counts()
            EP.reset_launch_counts()
            sync(device)
            t0 = time.perf_counter()
            logm, b_rounds, done = D.run_bp_banded(
                part, "lbp", mesh, 0, eps=1e-3, max_rounds=banded_rounds)
            sync(device)
            b_secs = time.perf_counter() - t0
            b_launches = TT.LAUNCHES["sum"]
            b_prelude = EP.LAUNCHES["edge_prelude"]
        finally:
            D.bp_banded._band = real_band
            undo()
        b_rounds = int(b_rounds)
        if not (b_rounds == int(one.rounds) and torch.equal(logm, one.logm)):
            raise AssertionError(
                f"banded LBP at n=1 differs from the one-device run: rounds "
                f"{b_rounds} vs {int(one.rounds)}")
        if b_launches < b_rounds:
            raise AssertionError(f"banded: {b_launches} fused_update_e "
                                 f"launches < {b_rounds} rounds")
        out["banded"] = dict(rounds=b_rounds, done=bool(done),
                             launches=b_launches,
                             prelude_launches=b_prelude, partition_s=part_s,
                             run_s=b_secs, band_setup_s=band_s[0],
                             bitwise=True, ms_per_round=(
                                 b_secs - band_s[0]) * 1e3 / max(b_rounds, 1),
                             kernel_check=check_slice(w["captured"]))
    return out


def to_device(pgm, device):
    """``pgm`` with every tensor on ``device`` (itself when it is there)."""
    import dataclasses
    import torch
    return dataclasses.replace(pgm, **{
        f.name: getattr(pgm, f.name).to(device)
        for f in dataclasses.fields(pgm)
        if isinstance(getattr(pgm, f.name), torch.Tensor)})


def result_digests(res) -> dict:
    """``digest`` of each result tensor, by field."""
    return {f: digest(getattr(res, f)) for f in
            ("logm", "beliefs", "rounds", "updates", "unconverged_history")}


def _gloo_bucket(mesh, device, rank, frames, scene, max_rounds):
    """Phase 17 (c) on one rank: ``frames`` stereo scenes built on the
    host, run through the sharded engine's ``run_many`` (one bucket; only
    the rank's slice reaches ``device``). Reports the rank's device bytes
    of graph and messages after ``init`` (the allocator's count and the
    tensors'), peak memory, loop time, launches and staged bytes; rank 0
    then runs the one-device ``run_many`` on the same frames beside it
    (``"triton"`` and its bucket fold on the card) and compares every
    field bitwise."""
    import torch
    from repro_torch import dist as D
    from repro_torch.core import (BatchedPGM, BPConfig, BPEngine,
                                  bucket_pgms, slot_generator)
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import stereo_mrf
    cuda = device.type == "cuda"
    allocated = torch.cuda.memory_allocated if cuda else (lambda: 0)
    host = [stereo_mrf(scene["height"], scene["width"], scene["n_disp"],
                       seed=s, device="cpu").pgm for s in range(frames)]
    cfg = dict(scheduler_kwargs=MAIN_KW, eps=1e-3, max_rounds=max_rounds)

    def resident(engine, make_batch):
        sync(device)
        m0 = allocated()
        state = engine.init(make_batch(), [slot_generator(0, i, device)
                                           for i in range(frames)])
        sync(device)
        return allocated() - m0, D.tensor_bytes(state.graph, state.logm)

    def run(engine, pgms):
        records = instrument(engine, TT.LAUNCHES)
        TT.reset_launch_counts()
        D.comm.reset_stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = engine.run_many(pgms, 0)
        sync(device)
        secs = time.perf_counter() - t0
        del engine.run, engine.step
        loop, = records
        return res, dict(
            run_s=secs, loop_s=loop["seconds"],
            iterations=loop["iterations"], rounds=loop["rounds"],
            ms_per_round=loop["seconds"] * 1e3 / max(loop["iterations"], 1),
            launches=TT.LAUNCHES["sum"],
            collectives=D.comm.STATS["collectives"],
            staged_bytes=D.comm.STATS["staged_bytes"],
            peak_memory_bytes=torch.cuda.max_memory_allocated() if cuda
            else None)

    eng = D.make_sharded_engine("rnbp", mesh, device=device, **cfg)
    memory, tensor = resident(eng, lambda: bucket_pgms(host)[0].batch)
    res, out = run(eng, host)
    out.update(memory_bytes=memory, tensor_bytes=tensor,
               n_edges=frames * host[0].n_edges,
               digests=[result_digests(r) for r in res])
    if rank == 0:
        card = [to_device(p, device) for p in host]
        one = BPEngine(BPConfig(
            scheduler="rnbp", backend=one_device_backend(device),
            batch_backend="triton" if cuda else None, **cfg), device=device)
        one_memory, one_tensor = resident(
            one, lambda: BatchedPGM.from_pgms(card))
        one_res, one_out = run(one, card)
        out["one"] = dict(one_out, memory_bytes=one_memory,
                          tensor_bytes=one_tensor,
                          bitwise=all(same_result(a, b) for a, b in
                                      zip(one_res, res)),
                          rounds_each=[int(r.rounds) for r in one_res])
    return out


def _gloo_entry(device, size):
    """Phase 25's ``distributed_bp --size size`` on this rank of phase
    17's world, as a user runs it (rank 0 prints; stdout captured): its
    sharded runs against its one-device runs (rounds, messages, beliefs
    bitwise), banded LBP's round parity, ``fused_update_e`` launches and
    wall seconds."""
    import contextlib
    import io
    import torch
    from repro_torch.examples import distributed_bp
    from repro_torch.kernels import triton_update as TT
    argv = ["--size", str(size)]
    if device.type != "cuda":
        argv += ["--device", device.type]
    TT.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = distributed_bp.main(argv)
    wall = time.perf_counter() - t0
    launches = TT.LAUNCHES["sum"]
    bitwise, rounds = {}, {}
    for name, row in res["sharded"].items():
        got, one = row["result"], res["one"][name]
        bitwise[name] = int(got.rounds) == int(one.rounds) and all(
            torch.equal(getattr(got, f), getattr(one, f))
            for f in ("logm", "beliefs"))
        rounds[name] = int(got.rounds)
    return dict(stdout=buf.getvalue(), bitwise=bitwise, rounds=rounds,
                parity=res["banded"]["parity"],
                banded_rounds=res["banded"]["rounds"], launches=launches,
                wall_s=wall)


def _gloo_rank(rank, size, out_dir, device_type, n, bucket, entry_size):
    """One rank of phase 17 (b) and (c), in its own process: sharded LBP
    and RnBP and banded LBP at ``DIST_EPS`` on Ising ``n`` x ``n`` (C =
    2.5) over a gloo world of ``size`` ranks, every tensor on
    ``device_type``; then (c), ``_gloo_bucket(**bucket)``; then phase 25's
    ``distributed_bp`` (``_gloo_entry``). Writes its results to
    ``out_dir/rank<r>.pt``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch import dist as D
    from repro_torch.core.schedulers import LBP, RnBP
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import ising_grid_fast
    device = torch.device(device_type)
    if device.type != "cuda":
        torch.set_num_threads(1)
    out = {}
    with world("gloo", Path(out_dir) / "store", size, rank):
        mesh = D.make_bp_mesh(device=device)
        out["transport"] = D.comm.transport(D.mesh_axis(mesh)[2], device)
        pgm = ising_grid_fast(n, 2.5, seed=0, device=device)
        for name, sched in (("lbp", LBP()), ("rnbp", RnBP(**MAIN_KW))):
            run = lambda: D.run_bp_sharded(  # noqa: E731
                pgm, sched, mesh, torch.Generator(device=device).manual_seed(
                    0), eps=DIST_EPS, max_rounds=DIST_ROUNDS[name],
                device=device)
            if name == "lbp":       # a first run split by collective
                w, undo = watch_dist(host=True)
                try:
                    t0 = time.perf_counter()
                    run()
                    split = dict(w["host_s"],
                                 total=time.perf_counter() - t0)
                finally:
                    undo()
            TT.reset_launch_counts()
            D.comm.reset_stats()
            t0 = time.perf_counter()
            res = run()
            sync(device)
            secs = time.perf_counter() - t0
            out[name] = dict(
                rounds=int(res.rounds), converged=bool(res.converged),
                logm=res.logm.cpu(), beliefs=res.beliefs.cpu(),
                updates=int(res.updates), run_s=secs,
                ms_per_round=secs * 1e3 / max(int(res.rounds), 1),
                launches=TT.LAUNCHES["sum"],
                collectives=D.comm.STATS["collectives"],
                staged_bytes=D.comm.STATS["staged_bytes"])
        out["lbp"]["split_ms_per_round"] = {
            k: v * 1e3 / DIST_ROUNDS["lbp"] for k, v in split.items()}
        TT.reset_launch_counts()
        D.comm.reset_stats()
        t0 = time.perf_counter()
        logm, rounds, done = D.run_bp_banded(
            D.partition_banded(pgm, size), "lbp", mesh, 0, eps=DIST_EPS,
            max_rounds=DIST_ROUNDS["lbp"])
        out["banded"] = dict(rounds=int(rounds), done=bool(done),
                             logm=logm.cpu(), run_s=time.perf_counter() - t0,
                             launches=TT.LAUNCHES["sum"],
                             staged_bytes=D.comm.STATS["staged_bytes"])
        t0 = time.perf_counter()
        out["bucket"] = _gloo_bucket(mesh, device, rank, **bucket)
        out["bucket"]["phase_s"] = time.perf_counter() - t0
        out["entry"] = _gloo_entry(device, entry_size)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def phase_dist_gloo(device, out_dir, n=PAPER_N, size=DIST_RANKS,
                    timeout_s=DIST_TIMEOUT_S, bucket=None,
                    entry_size=ENTRY_DIST_SIZE):
    """Phase 17 (b) and (c): ``size`` gloo ranks in spawned processes
    sharing ``device``. (b): sharded LBP (capped; it does not converge on
    Ising 200 x 200 at C = 2.5) and RnBP bitwise one-device runs of the same
    config -- rounds, messages, beliefs, updates -- and banded LBP the
    one-device rounds and messages bitwise. (c): phase 10's stereo frames
    (``bucket``: frames, scene, max_rounds) through ``run_many``, bitwise
    the one-device ``run_many`` rank 0 runs beside, each rank's bytes of
    graph and messages at most ``DIST_SHARE`` of one device's. Every rank's
    messages are bitwise equal. Then phase 25's ``distributed_bp --size
    entry_size`` on the same ranks (``entry``): sharded runs bitwise its
    one-device runs, banded round parity, only rank 0 printing."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch.pgm import ising_grid_fast
    bucket = bucket or dict(frames=STEREO_FRAMES, scene=STEREO,
                            max_rounds=STEREO_ROUNDS)
    cuda = device.type == "cuda"
    out_dir = Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_gloo_rank, args=(size, str(out_dir),
                                               device.type, n, bucket,
                                               entry_size),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"the gloo world did not finish in "
                                 f"{timeout_s} s")
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(size)]
    shutil.rmtree(out_dir, ignore_errors=True)
    pgm = ising_grid_fast(n, 2.5, seed=0, device=device)
    backend = one_device_backend(device)
    out = dict(ranks=size, transport=ranks[0]["transport"], wall_s=wall)
    for name, kw in (("lbp", {}), ("rnbp", MAIN_KW)):
        one, secs = run_engine(pgm, device, scheduler=name,
                               scheduler_kwargs=kw, eps=DIST_EPS,
                               max_rounds=DIST_ROUNDS[name], backend=backend)
        r = ranks[0][name]
        same = dict(rounds=r["rounds"] == int(one.rounds),
                    updates=r["updates"] == int(one.updates),
                    logm=torch.equal(r["logm"], one.logm.cpu()),
                    beliefs=torch.equal(r["beliefs"], one.beliefs.cpu()))
        if not all(same.values()):
            raise AssertionError(f"gloo sharded {name} differs from the "
                                 f"one-device run: {same}")
        out[name] = {k: v for k, v in r.items() if k not in ("logm",
                                                             "beliefs")}
        out[name].update(one_rounds=int(one.rounds), one_run_s=secs,
                         bitwise=True, staged_per_round=r["staged_bytes"]
                         / max(r["rounds"], 1))
    one, _ = run_engine(pgm, device, scheduler="lbp", eps=DIST_EPS,
                        max_rounds=DIST_ROUNDS["lbp"], backend=backend)
    b = ranks[0]["banded"]
    if not (b["rounds"] == int(one.rounds)
            and torch.equal(b["logm"], one.logm.cpu())):
        raise AssertionError(f"gloo banded LBP: rounds {b['rounds']} vs "
                             f"{int(one.rounds)}, or messages differ")
    out["banded"] = dict(rounds=b["rounds"], run_s=b["run_s"],
                         launches=b["launches"],
                         staged_bytes=b["staged_bytes"], bitwise=True)
    for other in ranks[1:]:
        for name in ("lbp", "rnbp", "banded"):
            if not torch.equal(other[name]["logm"], ranks[0][name]["logm"]):
                raise AssertionError(f"gloo {name}: ranks' messages differ")
    out["ranks_bitwise_equal"] = True
    out["bucket"] = check_gloo_bucket([r["bucket"] for r in ranks], cuda)
    out["entry"] = check_gloo_entry([r["entry"] for r in ranks], cuda)
    if cuda and min(r[k]["launches"] for r in ranks
                    for k in ("lbp", "rnbp", "banded")) < 1:
        raise AssertionError("a gloo rank bypassed fused_update_e")
    return out


def check_gloo_entry(ranks, cuda):
    """Phase 25's checks on ``distributed_bp``'s ranks: every sharded run
    bitwise its one-device run, banded LBP's rounds those of one device,
    the same rounds on every rank, only rank 0 printing, and on the card
    ``fused_update_e`` launched on every rank."""
    for i, r in enumerate(ranks):
        if not (all(r["bitwise"].values()) and r["parity"]):
            raise AssertionError(f"distributed_bp rank {i}: sharded bitwise "
                                 f"{r['bitwise']}, banded parity "
                                 f"{r['parity']}")
        if r["rounds"] != ranks[0]["rounds"] or (i > 0 and r["stdout"]):
            raise AssertionError(f"distributed_bp rank {i} differs from "
                                 "rank 0 or printed")
        if cuda and r["launches"] < max(r["rounds"].values()):
            raise AssertionError(f"distributed_bp rank {i}: {r['launches']} "
                                 "fused_update_e launches")
    return dict(stdout=ranks[0]["stdout"], rounds=ranks[0]["rounds"],
                banded_rounds=ranks[0]["banded_rounds"],
                launches=[r["launches"] for r in ranks],
                wall_s=max(r["wall_s"] for r in ranks), bitwise=True,
                parity=True)


def check_gloo_bucket(ranks, cuda):
    """Phase 17 (c)'s checks on the ranks' reports: rank 0's results
    bitwise the one-device run, every rank's the same bytes, a rank's bytes
    of graph and messages at most ``DIST_SHARE`` of one device's (by the
    allocator on the card, and by the tensors), and on the card at least
    one ``fused_update_e`` launch a loop iteration on every rank."""
    one = ranks[0]["one"]
    if not one["bitwise"]:
        raise AssertionError("(c) the sharded run_many differs from the "
                             "one-device run_many")
    if any(r["digests"] != ranks[0]["digests"] for r in ranks[1:]):
        raise AssertionError("(c) the ranks' results differ")
    out = dict(one=dict(one), ranks=[])
    for r in ranks:
        share = dict(tensor=r["tensor_bytes"] / one["tensor_bytes"])
        if cuda:
            share["memory"] = r["memory_bytes"] / one["memory_bytes"]
        if max(share.values()) > DIST_SHARE:
            raise AssertionError(f"(c) a rank holds {share} of one "
                                 f"device's graph and messages")
        if cuda and r["launches"] < r["iterations"]:
            raise AssertionError(f"(c) {r['launches']} fused_update_e "
                                 f"launches < {r['iterations']} iterations")
        out["ranks"].append(dict(
            {k: v for k, v in r.items() if k != "digests"}, share=share,
            staged_per_round=r["staged_bytes"] / max(r["iterations"], 1),
            staged_per_update=r["staged_bytes"] / max(r["launches"], 1)))
    out["bitwise"] = True
    return out


def log_dist(out) -> None:
    """Phase 17's progress lines."""
    a, b = out["one"], out["gloo"]
    s, bd, c = a["sharded"], a["banded"], b["bucket"]
    log(f"  (a) world of one, transport {a['transport']}: run_bp_sharded "
        f"RnBP {s['rounds']} rounds bitwise phase 4's run, "
        f"{s['ms_per_round']:.3f} ms/round (phase 4: "
        f"{out['main_ms_per_round']:.3f}), collectives "
        f"{s['collective_ms_per_round']:.4f} ms/round on the card ("
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    s["collective_ms_by_name"].items())
        + f"; {s['collectives']} calls), fused_update_e launches "
        f"{s['launches']}; slice vs plain "
        f"{s['kernel_check']['max_abs_err']:.3g}")
    log(f"      banded LBP n=1 capped at {bd['rounds']} rounds: bitwise the "
        f"one-device run, {bd['ms_per_round']:.3f} ms/round (the call "
        f"{bd['run_s']:.3f} s less the band's set-up "
        f"{bd['band_setup_s']:.3f} s), partition {bd['partition_s']:.3f} s, "
        f"launches {bd['launches']}; band vs plain "
        f"{bd['kernel_check']['max_abs_err']:.3g}")
    log(f"  (b) {b['ranks']} gloo ranks sharing the card, transport "
        f"{b['transport']}, {b['wall_s']:.1f} s with the spawn and (c): "
        + "; ".join(f"{k} {b[k]['rounds']} rounds bitwise the one-device "
                    f"run (converged {b[k]['converged']}), "
                    f"{b[k]['ms_per_round']:.3f} ms/round, "
                    f"{b[k]['collectives']} collectives, staged "
                    f"{b[k]['staged_per_round']:.0f} B/round, launches "
                    f"{b[k]['launches']}" for k in ("lbp", "rnbp"))
        + "; LBP's round on the host clock, ms (card synchronized before "
        "each collective): " + ", ".join(
            f"{k} {v:.3f}" for k, v in b["lbp"]["split_ms_per_round"].items())
        + f"; banded LBP {b['banded']['rounds']} rounds bitwise, "
        f"{b['banded']['run_s']:.3f} s staged {b['banded']['staged_bytes']} "
        f"B; ranks' messages bitwise equal")
    o = c["one"]
    log(f"  (c) run_many over the stereo bucket (B*E = "
        f"{c['ranks'][0]['n_edges']}), bitwise the one-device run_many "
        f"(rounds {o['rounds_each']}); one device: graph and messages "
        f"{o['memory_bytes']} B allocated ({o['tensor_bytes']} B of "
        f"tensors), peak {o['peak_memory_bytes']} B, "
        f"{o['ms_per_round']:.3f} ms/round")
    for i, r in enumerate(c["ranks"]):
        log(f"      rank {i}: {r['memory_bytes']} B allocated "
            f"({r['tensor_bytes']} B of tensors; share "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["share"].items())
            + f"), peak {r['peak_memory_bytes']} B, {r['iterations']} "
            f"iterations at {r['ms_per_round']:.3f} ms, staged "
            f"{r['staged_per_round']:.0f} B/iteration, "
            f"{r['staged_per_update']:.0f} B/launch ({r['collectives']} "
            f"collectives), fused_update_e launches {r['launches']}; (c) in "
            f"{r['phase_s']:.1f} s")


# ------------------------------------------------------------- phase 18 --

def lm_models(cfg, device, seed=0):
    """The port's model of ``cfg`` on the CPU, its weights from
    ``init_params`` with a seeded CPU generator, and a copy on ``device``."""
    import torch
    from repro_torch.models import build_model
    cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    card = build_model(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def lm_inputs(cfg, b, s, seed=1):
    """Prompt tokens (and the frontend stubs' embeddings) on the CPU."""
    import torch
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = 0.1 * torch.randn(
            b, cfg.n_frontend_tokens, cfg.d_model, generator=g)
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = 0.1 * torch.randn(b, s, cfg.d_model,
                                                     generator=g)
    return batch


def lm_err(name, card, cpu, tol=LM_TOL) -> float:
    """Max |card - cpu|; raises unless within ``tol`` (abs and rel)."""
    import torch
    card, cpu = card.detach().cpu().float(), cpu.detach().float()
    if card.shape != cpu.shape:
        raise AssertionError(f"{name}: shape {tuple(card.shape)} on the "
                             f"card, {tuple(cpu.shape)} on the CPU")
    err = float((card - cpu).abs().max()) if card.numel() else 0.0
    if not torch.allclose(card, cpu, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: card vs CPU max |diff| {err:.3g} "
                             f"beyond {tol} (abs and rel)")
    return err


@contextlib.contextmanager
def routes_recorded():
    """Every MoE routing decision (``top_e``) the port makes inside."""
    from repro_torch.models.layers import moe as M
    real, seen = M._route, []

    def record(p, xt, top_k, *rest):
        out = real(p, xt, top_k, *rest)
        seen.append(out[3].cpu())
        return out
    M._route = record
    try:
        yield seen
    finally:
        M._route = real


def host_syncs(fn, device):
    """Where ``fn`` makes a synchronizing CUDA call, as torch's sync debug
    mode reports them: one "file:line" of the caller per call; None off
    the card. The mode is switched on and off once before, so that
    nothing of its own first use is counted."""
    import warnings
    import torch
    if device.type != "cuda":
        return None
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message).lower()]


SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def profiled(fn):
    """A ``torch.profiler`` trace (host and card) of ``fn()``, begun after
    a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return prof


def sync_calls(prof) -> int:
    """The synchronizing CUDA runtime calls in a profiler trace."""
    return sum(ev.name in SYNC_CALLS for ev in prof.events())


def sync_baseline(device):
    """The synchronizing runtime calls of a trace of nothing, which every
    count is taken less; None when a control that reads one value to the
    host shows none more (the trace cannot see them) or off the card."""
    import torch
    if device.type != "cuda":
        return None
    one = torch.ones(8, device=device)
    base = sync_calls(profiled(lambda: None))
    if sync_calls(profiled(lambda: one.sum().item())) <= base:
        return None
    return base


def traced_syncs(fn, device):
    """A second witness for ``host_syncs``, whose detector torch calls a
    prototype: the synchronizing CUDA runtime calls a profiler trace of
    ``fn`` holds, less those of a trace of nothing (``sync_baseline``);
    None where the trace cannot see them."""
    base = sync_baseline(device)
    return None if base is None else sync_calls(profiled(fn)) - base


def lm_card_vs_cpu(cfg, device, b, s, steps):
    """``prefill`` logits and caches and ``steps`` decode steps from
    ``init_cache`` on the card against the CPU, same weights and tokens;
    MoE routing equal. Then the host syncs of one decode step on the card
    with the position on the card."""
    import torch
    cpu, card = lm_models(cfg, device)
    batch = lm_inputs(cfg, b, s)
    toks = torch.randint(0, cfg.vocab, (steps, b, 1),
                         generator=torch.Generator().manual_seed(2))

    def run(model):
        with routes_recorded() as routes:
            logits, cache = model.prefill(batch)
            dcache = model.init_cache(b, s + steps)
            step_logits = []
            for t in range(steps):
                lg, dcache = model.decode_step(dcache, toks[t], t)
                step_logits.append(lg)
        return logits, cache, step_logits, dcache, routes

    ref, got = run(cpu), run(card)
    out = dict(arch=cfg.name, family=cfg.family, b=b, s=s, steps=steps,
               prefill_err=lm_err(f"{cfg.name} prefill logits", got[0],
                                  ref[0]))
    out["cache_err"] = max(
        [lm_err(f"{cfg.name} prefill cache {g}/{k}", got[1][g][k], v)
         for g in ref[1] for k, v in ref[1][g].items()]
        + [lm_err(f"{cfg.name} decode cache {g}/{k}", got[3][g][k], v)
           for g in ref[3] for k, v in ref[3][g].items()])
    out["decode_err"] = max([lm_err(f"{cfg.name} decode step {t}", a, c)
                             for t, (a, c) in enumerate(zip(got[2], ref[2]))]
                            or [0.0])
    if len(got[4]) != len(ref[4]) or not all(
            torch.equal(a, c) for a, c in zip(got[4], ref[4])):
        raise AssertionError(f"{cfg.name}: MoE routing differs on the card")
    out["moe_routings"] = len(got[4])
    if steps:
        tok, pos = toks[0].to(card.device), torch.tensor(steps,
                                                         device=card.device)

        def step():
            card.decode_step(got[3], tok, pos)

        where = host_syncs(step, card.device)
        out["syncs_per_step"] = None if where is None else len(where)
        out["sync_sites"] = where
        out["traced_syncs_per_step"] = traced_syncs(step, card.device)
    return out


def percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


def lm_served(cfg, device, bw, b, prefill_len, prompt_len, gen, trace_steps,
              after=None, check_decode=True):
    """Phase 18 (c): ``cfg`` with weights drawn on the card, timed
    ``prefill`` over ``prefill_len`` tokens, ``launch.serve.generate``
    (``prompt_len`` prompt tokens, ``gen`` generated), its last prompt
    logits against ``prefill`` on the same prompt, and a profiler trace of
    ``trace_steps`` decode steps beside the decode bound. ``after(model,
    tokens)``, when given, runs last on the served model and the prompt
    tokens; its result is ``out["after"]``. ``check_decode=False``
    reports decode against prefill without bounding it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    on_card = device.type == "cuda"
    # what earlier phases still hold: peaks below are reported above it
    held = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    model = build_model(cfg, device=device).init_params(
        torch.Generator(device=device).manual_seed(0))
    sync(device)
    out = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, b=b,
               held_before_bytes=held, threads=threading.active_count(),
               gc_objects=len(gc.get_objects()),
               init_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()),
               param_bytes=sum(p.numel() * p.element_size()
                               for p in model.parameters()))
    tokens = torch.randint(0, cfg.vocab, (b, prefill_len),
                           generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(device)
    batch = {"tokens": tokens}

    def finite(name, t):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite logits")

    model.prefill(batch)                     # warm: cuBLAS plans, allocator
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch)
    if device.type == "cuda":
        end.record()
    sync(device)
    host_s = time.perf_counter() - t0
    finite("prefill", logits)
    block_params = sum(p.numel() for n, p in model.named_parameters()
                       if n.startswith(("blocks.", "lead_blocks.")))
    out["prefill"] = dict(
        tokens=b * prefill_len, host_s=host_s,
        event_s=start.elapsed_time(end) / 1e3 if device.type == "cuda"
        else None,
        tokens_per_s=b * prefill_len / host_s,
        matmul_tflops_per_s=2 * block_params * b * prefill_len / host_s
        / 1e12,
        peak_memory_bytes=torch.cuda.max_memory_allocated() - held
        if on_card else None)
    del logits, cache

    prompt = tokens[:, :prompt_len]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen_tokens, timings = generate(model, prompt, gen)
    peak = torch.cuda.max_memory_allocated() - held if on_card else None
    full, _ = model.prefill({"tokens": prompt})
    finite("prefill over the prompt", full)
    finite("decode after the prompt", timings["logits"])
    rel = float((timings["logits"].float() - full.float()).abs().max()
                / full.float().abs().max())
    if check_decode and not rel <= LM_DECODE_REL:
        raise AssertionError(f"decode vs prefill: max|d| / max|logit| = "
                             f"{rel:.3g} beyond {LM_DECODE_REL}")
    steps = timings["step_ms"][prompt_len:]
    out["serve"] = dict(
        prompt_len=prompt_len, gen=gen, tokens_shape=list(gen_tokens.shape),
        wall_s=timings["wall_s"],
        generated_tokens_per_s=b * gen / timings["wall_s"],
        prompt_step_ms_p50=percentile(timings["step_ms"][:prompt_len], 50),
        decode_step_ms_p50=percentile(steps, 50),
        decode_step_ms_p90=percentile(steps, 90),
        decode_tokens_per_s=b * 1e3 / percentile(steps, 50),
        decode_vs_prefill_rel=rel, peak_memory_bytes=peak)

    # decode bound: every weight and the head table read once, the whole
    # serve-length KV cache read once (the reference attends over it all)
    cache = model.init_cache(b, prompt_len + gen)
    kv_bytes = sum(t.numel() * t.element_size() for g in cache.values()
                   for t in g.values())
    head_bytes = out["param_bytes"]
    if not cfg.tie_embeddings:               # embed: only B rows gathered
        head_bytes -= model.embed.table.numel() * 4
    bound_bytes = head_bytes + kv_bytes
    out["bound"] = dict(bytes=bound_bytes, kv_bytes=kv_bytes,
                        decode_ms=bound_bytes / bw * 1e3, bound_by="bytes")

    tok = gen_tokens[:, :1]
    pos = torch.zeros((), dtype=torch.int64, device=device)

    def steps_run(n):
        nonlocal pos, cache
        for _ in range(n):
            lg, cache = model.decode_step(cache, tok, pos)
            pos = pos + 1
        return lg

    steps_run(2)
    sync(device)
    t0 = time.perf_counter()
    steps_run(trace_steps)
    sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        lg = steps_run(trace_steps)
        sync(device)
    finite("traced decode", lg)
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    busy_s, n_ops = busy_seconds(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["trace"] = dict(
        steps=trace_steps, wall_ms_per_step=wall_ms / trace_steps,
        busy_ms_per_step=busy_s * 1e3 / trace_steps,
        busy_share=busy_s * 1e3 / wall_ms,
        device_ops_per_step=n_ops / trace_steps,
        top_ms_per_step={k: v / trace_steps for k, v in top})
    if after is not None:
        out["after"] = after(model, tokens)
    return out


def phase_lm(device, wide_cfg=None, serve_cfg=None,
             family=LM_FAMILY, wide=LM_WIDE, serve=LM_SERVE, bw=3.35e12):
    """Phase 18, the LM stack's serving path: (a) every family at
    ``reduced()`` on the card against the CPU; (b) Qwen3-4B's width at
    ``wide["layers"]`` layers in float32, ``prefill`` over ``wide["s"]``
    tokens, card against CPU; (c) Qwen3-4B as published, served. The
    kernels of the BP path run nowhere here: their counts go from 0."""
    import torch
    from repro_torch import configs as TC
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: float32 card-vs-CPU "
                             "checks would lose three digits")
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    t0 = time.perf_counter()
    out = dict(families=[lm_card_vs_cpu(TC.get(a).reduced(), device,
                                        **family)
                         for a in TC.ARCH_IDS])
    out["families_s"] = time.perf_counter() - t0
    wide_cfg = wide_cfg or dataclasses.replace(
        TC.get("qwen3_4b"), n_layers=wide["layers"], dtype="float32")
    t0 = time.perf_counter()
    out["wide"] = lm_card_vs_cpu(wide_cfg, device, wide["b"], wide["s"], 0)
    out["wide_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["served"] = lm_served(serve_cfg or TC.get("qwen3_4b"), device, bw,
                              **serve)
    out["served_s"] = time.perf_counter() - t0
    out["launches"] = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                       "fused_update_e/sum": TT.LAUNCHES["sum"],
                       "fused_update_e/max": TT.LAUNCHES["max"],
                       "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    return out


def log_lm(out) -> None:
    """Phase 18's progress lines."""
    for f in out["families"]:
        log(f"  {f['arch']} ({f['family']}): card vs CPU prefill "
            f"{f['prefill_err']:.3g}, caches {f['cache_err']:.3g}, "
            f"{f['steps']} decode steps {f['decode_err']:.3g}; MoE "
            f"routings equal: {f['moe_routings']}; host syncs per decode "
            f"step: {f.get('syncs_per_step')} {f.get('sync_sites') or ''} "
            f"(sync debug mode), {f.get('traced_syncs_per_step')} (runtime "
            "calls in a profiler trace)")
    w = out["wide"]
    log(f"  {w['arch']} B={w['b']} S={w['s']} float32: card vs CPU prefill "
        f"{w['prefill_err']:.3g}, caches {w['cache_err']:.3g} "
        f"({out['wide_s']:.1f} s)")
    sv = out["served"]
    p, s, bd, tr = sv["prefill"], sv["serve"], sv["bound"], sv["trace"]
    log(f"  {sv['arch']} {sv['layers']} layers {sv['dtype']}: "
        f"{sv['params']:,} parameters, {sv['param_bytes'] / 1e9:.3f} GB, "
        f"drawn on the device in {sv['init_s']:.2f} s; earlier phases hold "
        f"{sv['held_before_bytes']} B (peaks below are above it); "
        f"{sv['threads']} threads alive, {sv['gc_objects']:,} objects "
        "tracked by the collector")
    log(f"  prefill B={sv['b']} x {p['tokens'] // sv['b']}: {p['host_s']:.4f} "
        f"s host ({p['event_s']} s events) = {p['tokens_per_s']:.0f} "
        f"tokens/s, block matmuls {p['matmul_tflops_per_s']:.1f} TFLOP/s, "
        f"peak {p['peak_memory_bytes']} B")
    log(f"  generate B={sv['b']} prompt {s['prompt_len']} + {s['gen']}: "
        f"{s['wall_s']:.3f} s, {s['generated_tokens_per_s']:.1f} generated "
        f"tokens/s; decode ms/step p50 {s['decode_step_ms_p50']:.3f} p90 "
        f"{s['decode_step_ms_p90']:.3f} (prompt steps p50 "
        f"{s['prompt_step_ms_p50']:.3f}) against a bound of "
        f"{bd['decode_ms']:.3f} ms ({bd['bytes'] / 1e9:.3f} GB at the "
        f"card's memory rate); peak {s['peak_memory_bytes']} B")
    log(f"  decode vs prefill over the prompt: max|d| / max|logit| = "
        f"{s['decode_vs_prefill_rel']:.3g} (limit {LM_DECODE_REL}); all "
        "logits finite")
    log(f"  trace of {tr['steps']} decode steps: {tr['wall_ms_per_step']:.3f} "
        f"ms/step wall (no profiler), device busy "
        f"{tr['busy_ms_per_step']:.3f} ms/step = share "
        f"{tr['busy_share']:.3f}, {tr['device_ops_per_step']:.0f} device "
        "ops/step")
    for name, ms in tr["top_ms_per_step"].items():
        log(f"  {ms:.4f} ms/step  {name[:110]}")
    log(f"  kernel launches on the LM path: {out['launches']}")


# ------------------------------------------------------------- phase 19 --

def train_state_on(cfg, device, seed=0):
    """``(model, state)`` of ``cfg`` on ``device``: float32 masters drawn
    on the CPU from ``seed`` (so every device gets the same ones)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state
    model = build_model(cfg, device=device)
    return model, init_train_state(model, torch.Generator().manual_seed(seed))


def train_pipe(cfg, device, b, s, seed=0):
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticLM
    return SyntheticLM(cfg, InputShape("train", s, b, "train"), seed=seed,
                       device=device)


def loss_and_grads(model, state, batch):
    """``forward_train`` on the step's cast copies, then backward: (metrics,
    {name: float32 gradient}), the masters' ``.grad`` cleared."""
    from repro_torch.train.step import compute_params
    loss, metrics = model.forward_train(compute_params(model, state.params),
                                        batch)
    loss.backward()
    grads = {}
    for n, p in state.params.items():
        grads[n], p.grad = p.grad, None
    return {k: v.detach() for k, v in metrics.items()}, grads


def rel_err(name, card, cpu, tol, scale=None) -> float:
    """max|card - cpu| / max|cpu| (or over ``scale``); raises beyond
    ``tol`` or on another shape."""
    card, cpu = card.detach().cpu().float(), cpu.detach().float()
    if card.shape != cpu.shape:
        raise AssertionError(f"{name}: shape {tuple(card.shape)} on the "
                             f"card, {tuple(cpu.shape)} on the CPU")
    scale = cpu.abs().max() if scale is None else scale
    err = float((card - cpu).abs().max() / scale.float().clamp_min(1e-30))
    if not err <= tol:
        raise AssertionError(f"{name}: card vs CPU max|diff| / max|cpu| = "
                             f"{err:.3g} beyond {tol}")
    return err


def state_leaves(state):
    """Every tensor of a train state by a name of its own."""
    return {**{f"params/{n}": t for n, t in state.params.items()},
            **{f"mu/{n}": t for n, t in state.opt.mu.items()},
            **{f"nu/{n}": t for n, t in state.opt.nu.items()},
            "count": state.opt.count, "step": state.step}


def same_state(name, a, b) -> None:
    """Raise unless two train states are bitwise equal."""
    import torch
    la, lb = state_leaves(a), state_leaves(b)
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    if differ:
        raise AssertionError(f"{name}: {len(differ)} leaves differ, e.g. "
                             f"{differ[:3]}")


def counted(counter, fn, device):
    """``counter(fn, device)`` (``host_syncs`` or ``traced_syncs``), and
    ``fn`` run once whatever the counter did (off the card it runs
    nothing)."""
    ran = []
    result = counter(lambda: ran.append(fn()), device)
    if not ran:
        fn()
    return result


def lm_train_card_vs_cpu(cfg, device, b, s, steps, ckpt_at, ckpt_dir):
    """Phase 19 (a) on one config: ``forward_train``'s metrics and every
    gradient leaf on the card against the CPU (same masters and batch),
    one ``adamw_update`` on the same gradients on both; then on the card a
    step with remat equal to one without (bitwise), two microbatches
    against one (params within 5e-3, xent within rtol 1e-4, the
    reference's bound), a run checkpointed at step ``ckpt_at`` and resumed
    bitwise the unbroken ``steps``-step run, and the host syncs of a train
    step (sync debug mode and runtime calls in a profiler trace)."""
    import shutil
    import torch
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.train import adamw_update, make_train_step
    from repro_torch.train.step import (load_reference_tree, reference_like,
                                        reference_tree)
    out = dict(arch=cfg.name, family=cfg.family, b=b, s=s, steps=steps,
               ckpt_at=ckpt_at)
    runs = []
    for dev in (torch.device("cpu"), device):
        model, state = train_state_on(cfg, dev)
        batch = train_pipe(cfg, dev, b, s).batch(0)
        runs.append((model, state) + loss_and_grads(model, state, batch))
    (_, cstate, cmet, cgrads), (model, state, met, grads) = runs
    if met.keys() != cmet.keys():
        raise AssertionError(f"{cfg.name}: metrics {sorted(met)} on the card, "
                             f"{sorted(cmet)} on the CPU")
    out["metric_err"] = max(lm_err(f"{cfg.name} {k}", met[k], cmet[k])
                            for k in cmet)
    out["grad_err"] = max(rel_err(f"{cfg.name} grad {n}", grads[n], g,
                                  LM_TOL) for n, g in cgrads.items())
    for st, g in ((cstate, cgrads),
                  (state, {n: v.to(device) for n, v in cgrads.items()})):
        adamw_update(st.params, g, st.opt, lr=1e-3)
    out["adamw_err"] = max(lm_err(f"{cfg.name} adamw {n}", t,
                                  state_leaves(cstate)[n])
                           for n, t in state_leaves(state).items())
    del runs, cstate, cgrads, grads

    def trained(n, start=None, **kw):
        """A fresh card state after ``n`` steps (or ``start``'s, further);
        no warmup, so the first step moves the masters."""
        model, st = start or train_state_on(cfg, device)
        step = make_train_step(model, base_lr=1e-3, warmup=0,
                               total_steps=steps, **kw)
        pipe = train_pipe(cfg, device, b, s)
        first = int(st.step)
        for i in range(first, first + n):
            st, m = step(st, pipe.batch(i))
        return (model, st), m, step, pipe

    (_, remat), m1, step, pipe = trained(1)
    (_, plain), m_plain, _, _ = trained(1, remat=False)
    same_state(f"{cfg.name}: remat=True vs remat=False", remat, plain)
    if not all(torch.equal(m1[k], m_plain[k]) for k in m1):
        raise AssertionError(f"{cfg.name}: remat changes the metrics")
    (_, micro), m2, _, _ = trained(1, microbatches=2)
    out["micro_param_diff"] = max(float((micro.params[n] - p).detach()
                                        .abs().max())
                                  for n, p in remat.params.items())
    out["micro_xent_rel"] = float(abs(m2["xent"] - m1["xent"])
                                  / abs(m1["xent"]))
    if not (out["micro_param_diff"] < 5e-3 and out["micro_xent_rel"] <= 1e-4):
        raise AssertionError(f"{cfg.name}: microbatches=2 vs 1: params "
                             f"{out['micro_param_diff']:.3g} (limit 5e-3), "
                             f"xent {out['micro_xent_rel']:.3g} (limit 1e-4)")
    del plain, micro

    # the unbroken run goes on from the remat state; its next two steps
    # are counted for host syncs
    where = counted(host_syncs, lambda: step(remat, pipe.batch(1)), device)
    out["syncs_per_step"] = None if where is None else len(where)
    out["sync_sites"] = where
    out["traced_syncs_per_step"] = counted(
        traced_syncs, lambda: step(remat, pipe.batch(2)), device)
    for i in range(3, steps):
        step(remat, pipe.batch(i))
    (model, broken), _, _, _ = trained(ckpt_at)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    save_pytree(str(ckpt_dir), ckpt_at, reference_tree(broken),
                extra={"data_step": ckpt_at})
    resumed = train_state_on(cfg, device, seed=1)
    tree, extra = restore_pytree(str(ckpt_dir), ckpt_at,
                                 reference_like(resumed[1]))
    load_reference_tree(resumed[1], tree)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    (_, resumed), _, _, _ = trained(steps - extra["data_step"], start=resumed)
    same_state(f"{cfg.name}: resumed at step {ckpt_at} vs unbroken",
               resumed, remat)
    out["resumed_bitwise"] = True
    return out


def lm_train_wide(cfg, device, b, s):
    """Phase 19 (b): ``cfg`` (Qwen3-4B's widths, cut in depth) in float32:
    the loss within ``LM_TRAIN_REL`` relative and every gradient leaf
    within ``LM_TRAIN_REL`` of its largest magnitude, card vs CPU."""
    import torch
    runs = []
    for dev in (torch.device("cpu"), device):
        model, state = train_state_on(cfg, dev)
        runs.append(loss_and_grads(model, state,
                                   train_pipe(cfg, dev, b, s).batch(0)))
        del model, state
    (cmet, cgrads), (met, grads) = runs
    return dict(arch=cfg.name, layers=cfg.n_layers, b=b, s=s,
                loss=float(cmet["loss"]),
                loss_rel=rel_err(f"{cfg.name} loss", met["loss"],
                                 cmet["loss"], LM_TRAIN_REL),
                grad_err=max(rel_err(f"{cfg.name} grad {n}", grads[n], g,
                                     LM_TRAIN_REL)
                             for n, g in cgrads.items()))


def lm_trained(cfg, device, b, s, steps, base_lr, warmup, synced, traced,
               peak_bf16):
    """Phase 19 (c): ``cfg`` as published, masters drawn on the card,
    ``steps`` steps of ``make_train_step(remat=True)`` on ``SyntheticLM``
    batches, each timed by CUDA events; step ``synced`` under torch's sync
    debug mode, the steps in ``traced`` under the profiler (busy share,
    device ops, synchronizing runtime calls). Checks: every loss and
    grad_norm finite, ``lr`` equal to ``cosine_lr`` at every step, and the
    mean loss over the first ``LM_TRAIN_EVAL`` batches, evaluated on the
    masters before the first step and after the last, lower by
    ``LM_TRAIN_DROP`` (the training losses themselves spike at this
    schedule: PERF.md, phase 19). The mean of the last three training
    losses against step 0's is reported as ``loss_drop``."""
    import torch
    from repro_torch.roofline import model_flops
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import cosine_lr
    from repro_torch.train.step import compute_params, init_train_state
    on_card = device.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    state = init_train_state(model, torch.Generator(device=device)
                             .manual_seed(0))
    sync(device)
    params = sum(p.numel() for p in state.params.values())
    out = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, b=b, s=s,
               steps=steps, base_lr=base_lr, warmup=warmup,
               init_s=time.perf_counter() - t0, params=params,
               held_before_bytes=held,
               model_flops_per_step=model_flops(state.params, b * s,
                                                cfg=cfg))
    pipe = train_pipe(cfg, device, b, s)
    step = make_train_step(model, base_lr=base_lr, warmup=warmup,
                           total_steps=steps, remat=True)
    def evaluated():
        with torch.no_grad():
            return [float(model.forward_train(
                compute_params(model, state.params), pipe.batch(i),
                remat=False)[0]) for i in range(LM_TRAIN_EVAL)]

    before = evaluated()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = sync_baseline(device)
    metrics, marks, kinds, prof = [], [], [], None

    def mark(kind=None):
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        if kind:
            kinds.append(kind)

    def run(i):
        metrics.append(step(state, pipe.batch(i))[1])

    t0 = time.perf_counter()
    mark()
    for i in range(steps):
        if i == synced:
            where = counted(host_syncs, lambda: run(i), device)
            mark("synced")
        elif on_card and i == traced[0]:
            # the traced steps share one interval
            t_tr = time.perf_counter()
            prof = profiled(lambda: [run(j) for j in traced])
            traced_wall_s = time.perf_counter() - t_tr
            mark("traced")
        elif not (on_card and i in traced):
            run(i)
            mark("plain")
    sync(device)
    out["wall_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    after = evaluated()
    if on_card:
        ms = [a.elapsed_time(c) for a, c in zip(marks, marks[1:])]
    else:
        ms = [(c - a) * 1e3 for a, c in zip(marks, marks[1:])]
    plain = [t for t, kind in zip(ms, kinds) if kind != "traced"]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    lrs = [float(m["lr"]) for m in metrics]
    want = [float(cosine_lr(torch.tensor(i, dtype=torch.int32,
                                         device=device), base_lr=base_lr,
                            warmup=warmup, total=steps))
            for i in range(steps)]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad_norm: {losses} "
                             f"{gnorms}")
    if lrs != want:
        raise AssertionError(f"lr {lrs} is not cosine_lr's {want}")
    eval_drop = (sum(before) - sum(after)) / LM_TRAIN_EVAL
    if not eval_drop > LM_TRAIN_DROP:
        raise AssertionError(f"mean loss over batches 0..{LM_TRAIN_EVAL - 1}"
                             f" {before} before training, {after} after: "
                             f"not {LM_TRAIN_DROP} lower")
    step_s = percentile(plain, 50) / 1e3
    out.update(
        losses=losses, grad_norms=gnorms, lrs=lrs, step_ms=ms,
        step_kinds=kinds,
        step_ms_p50=percentile(plain, 50), step_ms_p90=percentile(plain, 90),
        tokens_per_s=b * s / step_s,
        loss_drop=losses[0] - sum(losses[-3:]) / 3, eval_before=before,
        eval_after=after, eval_drop=eval_drop,
        mfu=out["model_flops_per_step"] / step_s / peak_bf16,
        model_tflops_per_s=out["model_flops_per_step"] / step_s / 1e12,
        peak_bf16=peak_bf16, peak_memory_bytes=peak,
        syncs_per_step=None if where is None else len(where),
        sync_sites=where)
    if prof is not None:
        busy_s, n_ops = busy_seconds(prof)
        n = len(traced)
        out["trace"] = dict(
            steps=n, wall_ms_per_step=traced_wall_s * 1e3 / n,
            busy_ms_per_step=busy_s * 1e3 / n,
            busy_share=busy_s / traced_wall_s,
            busy_over_untraced_step=busy_s * 1e3 / n / out["step_ms_p50"],
            device_ops_per_step=n_ops / n,
            traced_syncs_per_step=None if base is None
            else (sync_calls(prof) - base) / n)
    del model, state, metrics
    return out


def phase_lm_train(device, families=None, wide_cfg=None, train_cfg=None,
                   family=LM_TRAIN_FAMILY, wide=LM_TRAIN_WIDE,
                   train=LM_TRAIN, ckpt_dir=None, peak_bf16=None):
    """Phase 19, the LM stack's training path: (a) every family at
    ``reduced()`` card vs CPU and the step's invariants on the card; (b)
    Qwen3-4B's widths at ``wide["layers"]`` layers in float32, card vs
    CPU; (c) Qwen3-4B as published, trained. The BP kernels run nowhere
    here: their counts go from 0."""
    import torch
    from repro_torch import configs as TC
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: float32 card-vs-CPU "
                             "checks would lose three digits")
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    ckpt_dir = ckpt_dir or REPO / "chiprun_out" / "lm_train_ckpt"
    t0 = time.perf_counter()
    out = dict(families=[
        lm_train_card_vs_cpu(cfg, device, ckpt_dir=ckpt_dir, **family)
        for cfg in families or [TC.get(a).reduced() for a in TC.ARCH_IDS]])
    out["families_s"] = time.perf_counter() - t0
    wide_cfg = wide_cfg or dataclasses.replace(
        TC.get("qwen3_4b"), n_layers=wide["layers"], dtype="float32")
    t0 = time.perf_counter()
    out["wide"] = lm_train_wide(wide_cfg, device, wide["b"], wide["s"])
    out["wide_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["trained"] = lm_trained(train_cfg or TC.get("qwen3_4b"), device,
                                peak_bf16=peak_bf16 or bf16_peak(
                                    torch.cuda.get_device_name(0)),
                                **train)
    out["trained_s"] = time.perf_counter() - t0
    out["launches"] = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                       "fused_update_e/sum": TT.LAUNCHES["sum"],
                       "fused_update_e/max": TT.LAUNCHES["max"],
                       "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    return out


def log_lm_train(out) -> None:
    """Phase 19's progress lines."""
    for f in out["families"]:
        log(f"  {f['arch']} ({f['family']}) B={f['b']} S={f['s']}: card vs "
            f"CPU metrics {f['metric_err']:.3g}, gradients "
            f"{f['grad_err']:.3g} (of max), one adamw_update "
            f"{f['adamw_err']:.3g}; remat on == off bitwise; 2 microbatches "
            f"vs 1: params {f['micro_param_diff']:.3g}, xent "
            f"{f['micro_xent_rel']:.3g}; resumed at step {f['ckpt_at']} "
            f"bitwise the unbroken {f['steps']} steps; host syncs per train "
            f"step: {f['syncs_per_step']} {f['sync_sites'] or ''} (sync debug "
            f"mode), {f['traced_syncs_per_step']} (runtime calls in a "
            "profiler trace)")
    log(f"  families in {out['families_s']:.1f} s")
    w = out["wide"]
    log(f"  {w['arch']} {w['layers']} layers float32 B={w['b']} S={w['s']}: "
        f"loss {w['loss']:.5f}, card vs CPU {w['loss_rel']:.3g} (relative), "
        f"gradients {w['grad_err']:.3g} (of max) ({out['wide_s']:.1f} s)")
    t = out["trained"]
    log(f"  {t['arch']} {t['layers']} layers {t['dtype']} over float32 "
        f"masters: {t['params']:,} parameters, drawn on the device in "
        f"{t['init_s']:.2f} s; earlier phases hold {t['held_before_bytes']} B")
    log(f"  {t['steps']} steps B={t['b']} S={t['s']} lr {t['base_lr']} warmup "
        f"{t['warmup']}: ms/step p50 {t['step_ms_p50']:.1f} p90 "
        f"{t['step_ms_p90']:.1f} (CUDA events, untraced steps; each "
        "interval: " + ", ".join(f"{x:.1f} {k}" for x, k in
                                 zip(t["step_ms"], t["step_kinds"])) + ")")
    log(f"  {t['tokens_per_s']:.0f} tokens/s; model_flops "
        f"{t['model_flops_per_step'] / 1e12:.2f} TFLOP/step = "
        f"{t['model_tflops_per_s']:.1f} TFLOP/s, mfu {t['mfu']:.4f} of "
        f"{t['peak_bf16'] / 1e12:.0f} TFLOP/s dense bf16; peak memory "
        f"{t['peak_memory_bytes']} B; host syncs per step "
        f"{t['syncs_per_step']} {t['sync_sites'] or ''}")
    if "trace" in t:
        tr = t["trace"]
        log(f"  trace of {tr['steps']} steps: {tr['wall_ms_per_step']:.1f} "
            f"ms/step wall under the profiler, device busy "
            f"{tr['busy_ms_per_step']:.1f} ms/step = share "
            f"{tr['busy_share']:.3f} of it, "
            f"{tr['busy_over_untraced_step']:.3f} of the untraced p50 step; "
            f"{tr['device_ops_per_step']:.0f} "
            f"device ops/step, {tr['traced_syncs_per_step']} synchronizing "
            "runtime calls/step")
    log("  loss " + ", ".join(f"{x:.4f}" for x in t["losses"])
        + f" (mean of the last three {t['loss_drop']:.4f} below step 0's)")
    log(f"  loss over batches 0..{len(t['eval_before']) - 1} on the masters: "
        + ", ".join(f"{x:.4f}" for x in t["eval_before"]) + " before, "
        + ", ".join(f"{x:.4f}" for x in t["eval_after"]) + " after: "
        f"{t['eval_drop']:.4f} lower (limit {LM_TRAIN_DROP})")
    log("  grad_norm " + ", ".join(f"{x:.4f}" for x in t["grad_norms"]))
    log(f"  kernel launches on the LM training path: {out['launches']}")


# ------------------------------------------------------------- phase 20 --

def shard_key(cfg) -> str:
    """A case of phase 20: the config's name, and its MoE dispatch."""
    return f"{cfg.name}/{cfg.moe_dispatch}" if cfg.n_experts else cfg.name


def shard_families(families=LM_SHARD_FAMILIES):
    """The reduced configs phase 20 shards over "model"."""
    from repro_torch import configs as TC
    return [dataclasses.replace(TC.get(a).reduced(), moe_dispatch=d)
            if d else TC.get(a).reduced() for a, d in families]


def one_device_cfg(cfg):
    """``cfg`` as one device runs it: the "sharded" dispatch needs a mesh,
    and on one device it is the "ragged" one."""
    return dataclasses.replace(cfg, moe_dispatch="ragged") \
        if cfg.moe_dispatch == "sharded" else cfg


def moe_prompt(cfg, b, n, s, seed=1):
    """The first ``s`` of phase 18's (b, n) prompt tokens for ``cfg``."""
    import torch
    return torch.randint(0, cfg.vocab, (b, n),
                         generator=torch.Generator().manual_seed(seed))[:, :s]


def decode_run(model, batch, toks, cache_len, caches=True, timed=False,
               routes=False):
    """``prefill(batch)``, then ``len(toks)`` decode steps from
    ``init_cache(B, cache_len)``; host copies of the logits (and of the
    caches, as this rank holds them; and of every MoE routing choice with
    ``routes``). With ``timed``: each step's seconds (a synchronize each
    side). The collectives and staged bytes of the decode steps come from
    ``dist.comm.STATS``."""
    import torch
    from repro_torch.dist import comm
    dev = model.device
    b = batch["tokens"].shape[0]
    record = routes_recorded() if routes else contextlib.nullcontext([])
    with record as seen:
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch)
        sync(dev)
        out = dict(prefill_s=time.perf_counter() - t0, logits=logits.cpu())
        if caches:
            out["cache"] = {g: {k: v.cpu() for k, v in leaves.items()}
                            for g, leaves in cache.items()}
            out["specs"] = getattr(cache, "specs", None)
        del cache
        dcache = model.init_cache(b, cache_len)
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        comm.reset_stats()
        steps, step_s = [], []
        for tok in toks:
            sync(dev)
            t0 = time.perf_counter()
            lg, dcache = model.decode_step(dcache, tok.to(dev), pos)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
            steps.append(lg.cpu())
            pos = pos + 1
    out.update(steps=steps, collectives=comm.STATS["collectives"],
               staged_bytes=comm.STATS["staged_bytes"])
    if timed:
        out["step_s"] = step_s
    if routes:
        out["routes"] = list(seen)
    if caches:
        out["dcache"] = {g: {k: v.cpu() for k, v in leaves.items()}
                         for g, leaves in dcache.items()}
        out["dspecs"] = getattr(dcache, "specs", None)
    return out


def family_run(cfg, device, b, s, steps, mesh=None):
    """A reduced family's ``decode_run`` on ``device`` (on ``mesh`` when
    given), weights from ``init_params`` with a CPU generator of seed 0."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, device=device, mesh=mesh).init_params(
        torch.Generator().manual_seed(0))
    batch = {k: v.to(device) for k, v in lm_inputs(cfg, b, s).items()}
    toks = torch.randint(0, cfg.vocab, (steps, b, 1),
                         generator=torch.Generator().manual_seed(2))
    return decode_run(model, batch, toks, s + steps)


def prompt_run(model, prompt, steps, **kw):
    """``decode_run`` over ``prompt`` (B, S): its prefill, then its first
    ``steps`` tokens fed one by one from an empty cache of ``steps``."""
    return decode_run(model, {"tokens": prompt},
                      [t[:, None] for t in prompt.T[:steps]], steps,
                      caches=False, **kw)


def same_run(name, got, want) -> None:
    """Raise unless two ``decode_run``s are bitwise equal: logits, every
    step, every cache leaf."""
    import torch
    pairs = [("prefill logits", got["logits"], want["logits"])]
    pairs += [(f"step {t}", a, c) for t, (a, c) in enumerate(
        zip(got["steps"], want["steps"]))]
    for which in ("cache", "dcache"):
        pairs += [(f"{which} {g}/{k}", got[which][g][k], v)
                  for g in want.get(which, {})
                  for k, v in want[which][g].items()]
    for what, a, c in pairs:
        if not torch.equal(a, c):
            raise AssertionError(f"{name}: {what} differs")


def rel_logit_err(name, got, want, limit=None) -> float:
    """max|got - want| / max|want|; raises on a non-finite logit and
    beyond ``limit`` (when one is given)."""
    import torch
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite logits")
    rel = float((got - want).abs().max() / want.abs().max())
    if limit is not None and not rel <= limit:
        raise AssertionError(f"{name}: max|d| / max|logit| = {rel:.3g} "
                             f"beyond {limit}")
    return rel


@contextlib.contextmanager
def routes_pinned(table):
    """Inside, the n-th MoE routing call takes the experts ``table[n]``
    (a recorded run's ``top_e``, in call order) with weights from its own
    probabilities at them, renormalized as ``_route`` does; yields the
    list of how many rows of each call would have chosen other experts."""
    from repro_torch.models.layers import moe as M
    real, flips = M._route, []

    def pinned(p, xt, top_k, *rest):
        logits, probs, _, own = real(p, xt, top_k, *rest)
        want = table[len(flips)]
        flips.append(route_flips([own.cpu()], [want])[0])
        top_e = want.to(own.device)
        top_p = probs.gather(-1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        return logits, probs, top_p, top_e
    M._route = pinned
    try:
        yield flips
    finally:
        M._route = real


def route_flips(got, want):
    """The routing decisions (token, MoE layer) of two runs' recorded
    routes that chose other experts: per recorded call, the rows whose
    expert sets differ."""
    return [int((a.sort(-1).values != c.sort(-1).values).any(-1).sum())
            for a, c in zip(got, want)]


def decode_vs_prefill(model, prompt, limit=None):
    """The reference's decode-matches-prefill statistic at full depth:
    ``prefill(prompt)`` against the prompt fed through ``decode_step``
    (``generate`` with one new token), max|d| / max|logit| of the last
    prompt position (bounded by ``limit`` when given), and the routing
    decisions of the decode steps that differ from the prefill's, per MoE
    layer."""
    from repro_torch.launch.serve import generate
    b, s = prompt.shape
    with routes_recorded() as pre:
        logits, _ = model.prefill({"tokens": prompt})
    with routes_recorded() as dec:
        _, timings = generate(model, prompt, 1)
    layers = len(pre)
    flips = [sum(route_flips([dec[t * layers + i]],
                             [pre[i].view(b, s, -1)[:, t]])[0]
                 for t in range(s)) for i in range(layers)]
    return dict(rel=rel_logit_err(f"{model.cfg.name} {model.cfg.dtype} "
                                  "decode vs prefill", timings["logits"],
                                  logits.cpu(), limit),
                flips_per_layer=flips, decisions_per_layer=b * s)


def lm_moe_refs(model, tokens, prompt_len, sharded, limit=None):
    """One device's numbers for phase 20 on ``model``: decode against
    prefill over ``prompt_len`` tokens (within ``limit``, when given); the
    logits and routes of
    ``prompt_run`` over ``sharded["s"]`` tokens (what (c)'s ranks are held
    to); the host syncs of one decode step."""
    import torch
    dev = model.device
    out = decode_vs_prefill(model, tokens[:, :prompt_len], limit)
    out["run"] = prompt_run(model, tokens[:, :sharded["s"]],
                            sharded["steps"], routes=True)
    cache = model.init_cache(tokens.shape[0], 4)
    tok, pos = tokens[:, :1], torch.zeros((), dtype=torch.int64, device=dev)

    def step():
        model.decode_step(cache, tok, pos)
    step()
    where = host_syncs(step, dev)
    out.update(syncs_per_step=None if where is None else len(where),
               sync_sites=sorted(set(where or ())),
               moe_layers=sum(1 for p_l in model.blocks if "moe" in p_l),
               traced_syncs_per_step=traced_syncs(step, dev))
    return out


def lm_moe_one(cfg, device, store, prompt, want, backend):
    """(b)'s world of one over ``backend`` at full depth: ``prefill`` on
    the ``(1, 1)`` mesh, weights drawn as (b) drew them, bitwise (b)'s
    logits ``want``."""
    import torch
    from repro_torch.ft import ElasticMesh
    from repro_torch.models import build_model
    with world(backend, store):
        mesh = ElasticMesh(1, device=device).current()
        model = build_model(cfg, device=device, mesh=mesh).init_params(
            torch.Generator(device=device).manual_seed(0))
        logits, _ = model.prefill({"tokens": prompt.to(device)})
        del model
    if not torch.equal(logits.cpu(), want):
        raise AssertionError("granite at full depth on a world of one "
                             "differs from the one-device prefill")
    return True


def _lm_shard_rank(rank, size, out_dir, device_type, job):
    """One rank of phase 20's gloo world, in its own process, every tensor
    on ``device_type``: (a) each reduced family of ``job["families"]`` on
    the meshes whose "model" axis has ``job["mps"]`` ranks; (c) Granite at
    full depth over all ranks on "model" (``job["full"]``): in float32
    with one device's routing pinned (``job["pin"]``), in bf16 pinned the
    same way, then in bf16 as it routes, timed. Writes ``rank<r>.pt``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.dist import comm
    from repro_torch.ft import ElasticMesh
    from repro_torch.models import build_model
    device = torch.device(device_type)
    if device.type != "cuda":
        torch.set_num_threads(1)
    out = dict(families={}, full={})
    with world("gloo", Path(out_dir) / "store", size, rank):
        for mp_ in job["mps"]:
            mesh = ElasticMesh(mp_, device=device).current()
            shape = tuple(mesh.mesh.shape)
            for cfg in job["families"]:
                out["families"][(shape, shard_key(cfg))] = dict(
                    family_run(cfg, device, mesh=mesh, **job["family"]),
                    coord=tuple(mesh.get_coordinate()))
        mesh = ElasticMesh(size, device=device).current()
        cfg, f = job["full"]
        prompt = moe_prompt(cfg, f["b"], f["n"], f["s"]).to(device)
        for dtype, runs in (("float32", ("pinned",)),
                            ("bfloat16", ("pinned", "own"))):
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = build_model(dataclasses.replace(cfg, dtype=dtype),
                                device=device, mesh=mesh).init_params(
                torch.Generator(device=device).manual_seed(0))
            sync(device)
            init_s = time.perf_counter() - t0
            model.prefill({"tokens": prompt})          # warm
            for routing in runs:
                pin = job["pin"][dtype] if routing == "pinned" else None
                with routes_pinned(pin) if pin else \
                        contextlib.nullcontext() as flips:
                    run = prompt_run(model, prompt, f["steps"], timed=True,
                                     routes=pin is None)
                out["full"][f"{dtype}/{routing}"] = dict(
                    run, init_s=init_s, pinned_flips=flips,
                    transport=comm.transport(mesh.get_group("model"),
                                             device),
                    param_bytes=sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
                    peak_memory_bytes=torch.cuda.max_memory_allocated()
                    if device.type == "cuda" else None)
            del model
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def lm_shard_one(device, store, families, refs, family, backend):
    """Phase 20 (a), a world of one over ``backend``: each family on the
    ``(1, 1)`` mesh bitwise its one-device run ``refs[key]``."""
    from repro_torch.ft import ElasticMesh
    out = {}
    with world(backend, store):
        mesh = ElasticMesh(1, device=device).current()
        for cfg in families:
            got = family_run(cfg, device, mesh=mesh, **family)
            same_run(f"{shard_key(cfg)} on a world of one vs one device",
                     got, refs[shard_key(cfg)])
            out[shard_key(cfg)] = True
    return out


def check_families(ranks, refs):
    """Phase 20 (a) over the gloo ranks: every case within ``LM_TOL`` of
    one device, ranks bitwise equal, each rank's cache blocks its slices
    of the one-device caches."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import shard_tensor
    out = {}
    for (shape, key), run in ranks[0]["families"].items():
        ref = refs[key]
        mesh = AbstractMesh(shape, ("data", "model"))
        errs = [lm_err(f"{key} {shape} prefill", run["logits"],
                       ref["logits"])]
        errs += [lm_err(f"{key} {shape} step {t}", a, c)
                 for t, (a, c) in enumerate(zip(run["steps"],
                                                ref["steps"]))]
        cache_err = 0.0
        for r in ranks:
            mine = r["families"][(shape, key)]
            same_run(f"{key} {shape} rank vs rank 0",
                     dict(logits=mine["logits"], steps=mine["steps"]),
                     dict(logits=run["logits"], steps=run["steps"]))
            for which, specs in (("cache", "specs"), ("dcache", "dspecs")):
                for g, leaves in ref[which].items():
                    for k, v in leaves.items():
                        cache_err = max(cache_err, lm_err(
                            f"{key} {shape} {which} {g}/{k} block",
                            mine[which][g][k],
                            shard_tensor(v, mine[specs][g][k], mesh,
                                         coordinate=mine["coord"])))
        out[f"{key} {shape[0]}x{shape[1]}"] = dict(
            err=max(errs), cache_err=cache_err,
            collectives_per_step=run["collectives"] / max(
                len(run["steps"]), 1))
    return out


def phase_lm_shard(device, out_dir, bw=3.35e12, families=None,
                   moe_cfg=None, backend="nccl",
                   family=LM_SHARD_FAMILY, serve=LM_MOE_SERVE,
                   sharded=LM_MOE_SHARDED, size=LM_SHARD_RANKS,
                   timeout_s=LM_SHARD_TIMEOUT_S):
    """Phase 20, the LM stack's sharded serving path: (a) the reduced
    families on a world of one over ``backend`` bitwise one device, then
    over ``size`` gloo ranks sharing ``device`` (meshes ``(1, size)`` and
    ``(size, 1)``) within ``LM_TOL``; (b) Granite-MoE 3B as published
    (``moe_cfg``) served on one device in bf16, its prefill on a world of
    one bitwise, and decode against prefill at full depth in float32
    within ``LM_TOL`` (in bf16 routing flips between the two passes
    cascade through the layers: reported, not bounded); (c) Granite at
    full depth over the gloo ranks with the "sharded" dispatch: in float32
    within ``LM_TOL`` of one device, then in bf16, timed, against the
    one-device bf16 logits (reported with its routing flips). The BP
    kernels run nowhere here: their counts go from 0."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch import configs as TC
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.models import build_model
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    out_dir = Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    families = families or shard_families()
    moe_cfg = moe_cfg or TC.get("granite_moe_3b_a800m")
    out = {}
    t0 = time.perf_counter()
    refs = {shard_key(cfg): family_run(one_device_cfg(cfg), device, **family)
            for cfg in families}
    out["one"] = lm_shard_one(device, out_dir / "store_one", families, refs,
                              family, backend)
    out["a_one_s"] = time.perf_counter() - t0
    log(f"  (a) one device and a world of one: {out['a_one_s']:.1f} s")

    # (b) Granite-MoE 3B as published, one device, "ragged": served in
    # bf16, then the same weights in float32
    t0 = time.perf_counter()
    served = lm_served(moe_cfg, device, bw, **serve, check_decode=False,
                       after=lambda m, tokens: lm_moe_refs(
                           m, tokens, serve["prompt_len"], sharded))
    mrefs = {"bfloat16": served.pop("after")}
    prompt = moe_prompt(moe_cfg, serve["b"], serve["prefill_len"],
                        sharded["s"])
    served["world_of_one_bitwise"] = lm_moe_one(
        moe_cfg, device, out_dir / "store_moe", prompt,
        mrefs["bfloat16"]["run"]["logits"], backend)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    f32 = build_model(dataclasses.replace(moe_cfg, dtype="float32"),
                      device=device).init_params(
        torch.Generator(device=device).manual_seed(0))
    mrefs["float32"] = lm_moe_refs(f32, moe_prompt(
        moe_cfg, serve["b"], serve["prefill_len"],
        serve["prefill_len"]).to(device), serve["prompt_len"], sharded,
        limit=LM_TOL)
    del f32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    served.update(
        {k: mrefs["bfloat16"][k] for k in ("syncs_per_step", "sync_sites",
                                           "moe_layers",
                                           "traced_syncs_per_step")},
        decode_vs_prefill={d: dict(rel=m["rel"],
                                   flips_per_layer=m["flips_per_layer"],
                                   decisions_per_layer=m[
                                       "decisions_per_layer"])
                           for d, m in mrefs.items()})
    out["served"] = served
    out["b_s"] = time.perf_counter() - t0
    log(f"  (b) served, references, world of one: {out['b_s']:.1f} s")

    # (a) and (c) over the gloo ranks, one spawn
    job = {"families": families, "mps": (size, 1),
           "family": family,
           "pin": {d: m["run"]["routes"] for d, m in mrefs.items()},
           "full": (dataclasses.replace(moe_cfg, moe_dispatch="sharded"),
                    dict(sharded, n=serve["prefill_len"], b=serve["b"]))}
    t0 = time.perf_counter()
    ctx = mp.start_processes(_lm_shard_rank, args=(size, str(out_dir),
                                                   device.type, job),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"phase 20's gloo world did not finish in "
                                 f"{timeout_s} s")
    out["gloo_wall_s"] = time.perf_counter() - t0
    log(f"  (a), (c) gloo ranks: {out['gloo_wall_s']:.1f} s with the spawn")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(size)]
    shutil.rmtree(out_dir, ignore_errors=True)

    out["families"] = check_families(ranks, refs)

    # (c) full depth over the ranks: float32 with one device's routing
    # pinned, held to LM_TOL; bf16 pinned and as it routes, reported
    out["sharded"] = {}
    for key, full in ranks[0]["full"].items():
        dtype, routing = key.split("/")
        ref = mrefs[dtype]["run"]
        for r in ranks[1:]:
            same_run(f"granite {key} rank vs rank 0", r["full"][key], full)
        limit = LM_TOL if dtype == "float32" else None
        n = len(full["steps"])
        flips = full["pinned_flips"] if routing == "pinned" \
            else route_flips(full["routes"], ref["routes"])
        out["sharded"][key] = dict(
            b=serve["b"], s=sharded["s"], steps=n,
            transport=full["transport"],
            prefill_rel=rel_logit_err(f"granite {key} sharded prefill",
                                      full["logits"], ref["logits"], limit),
            step_rel=max(rel_logit_err(f"granite {key} sharded step {t}",
                                       a, c, limit)
                         for t, (a, c) in enumerate(zip(full["steps"],
                                                        ref["steps"]))),
            routes_pinned=routing == "pinned", route_flips=sum(flips),
            route_decisions=sum(int(t.shape[0]) for t in ref["routes"]),
            prefill_s=full["prefill_s"], init_s=full["init_s"],
            decode_step_ms_p50=percentile(full["step_s"], 50) * 1e3,
            decode_step_ms_p90=percentile(full["step_s"], 90) * 1e3,
            collectives_per_step=full["collectives"] / n,
            staged_bytes_per_step=full["staged_bytes"] / n,
            rank_param_bytes=[r["full"][key]["param_bytes"] for r in ranks],
            rank_peak_memory_bytes=[r["full"][key]["peak_memory_bytes"]
                                    for r in ranks])
    if max(out["sharded"]["bfloat16/own"]["rank_param_bytes"]) > \
            0.6 * served["param_bytes"]:
        raise AssertionError("a rank holds more than 0.6 of the model")
    out["launches"] = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                       "fused_update_e/sum": TT.LAUNCHES["sum"],
                       "fused_update_e/max": TT.LAUNCHES["max"],
                       "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    return out


def log_lm_shard(out) -> None:
    """Phase 20's progress lines."""
    log(f"  (a) world of one: {len(out['one'])} cases bitwise the "
        f"one-device run ({out['a_one_s']:.1f} s with the references)")
    for key, f in out["families"].items():
        log(f"  (a) {key}: vs one device {f['err']:.3g}, cache blocks "
            f"{f['cache_err']:.3g}, {f['collectives_per_step']:.0f} "
            "collectives/decode step; ranks bitwise equal")
    sv = out["served"]
    p, s, bd = sv["prefill"], sv["serve"], sv["bound"]
    log(f"  (b) {sv['arch']} {sv['layers']} layers {sv['dtype']}: "
        f"{sv['params']:,} parameters, {sv['param_bytes'] / 1e9:.3f} GB, "
        f"drawn in {sv['init_s']:.2f} s; prefill B={sv['b']} x "
        f"{p['tokens'] // sv['b']}: {p['tokens_per_s']:.0f} tokens/s "
        f"({p['host_s']:.4f} s), peak {p['peak_memory_bytes']} B")
    log(f"  (b) generate prompt {s['prompt_len']} + {s['gen']}: "
        f"{s['generated_tokens_per_s']:.1f} generated tokens/s; decode "
        f"ms/step p50 {s['decode_step_ms_p50']:.3f} p90 "
        f"{s['decode_step_ms_p90']:.3f} against a bound of "
        f"{bd['decode_ms']:.3f} ms ({bd['bytes'] / 1e9:.3f} GB); peak "
        f"{s['peak_memory_bytes']} B")
    for dtype, d in sv["decode_vs_prefill"].items():
        log(f"  (b) decode vs prefill, {dtype}: max|d| / max|logit| "
            f"{d['rel']:.4g}; routing decisions that differ, per MoE layer "
            f"(of {d['decisions_per_layer']}): {d['flips_per_layer']}")
    log(f"  (b) host syncs per decode step: {sv['syncs_per_step']} "
        f"{sv['sync_sites']} (sync debug mode; {sv['moe_layers']} MoE "
        f"layers), {sv['traced_syncs_per_step']} (runtime calls in a "
        f"trace); trace busy share {sv['trace']['busy_share']:.3f}, "
        f"{sv['trace']['device_ops_per_step']:.0f} device ops/step; world "
        f"of one prefill bitwise: {sv['world_of_one_bitwise']}")
    for key, c in out["sharded"].items():
        log(f"  (c) granite full depth {key}, {c['transport']}: prefill "
            f"B={c['b']} x {c['s']} rel {c['prefill_rel']:.3g}, "
            f"{c['steps']} decode steps rel {c['step_rel']:.3g} (against one "
            f"device; its routing pinned: {c['routes_pinned']}); routing "
            f"decisions of its own that differ {c['route_flips']} of "
            f"{c['route_decisions']}; prefill {c['prefill_s']:.3f} s, decode "
            f"ms/step p50 {c['decode_step_ms_p50']:.3f} p90 "
            f"{c['decode_step_ms_p90']:.3f}; {c['collectives_per_step']:.0f} "
            f"collectives and {c['staged_bytes_per_step']:.0f} B staged per "
            f"step; rank parameter bytes {c['rank_param_bytes']}, peaks "
            f"{c['rank_peak_memory_bytes']}")
    log(f"  (c) one device holds {sv['param_bytes']} B in bf16; gloo world "
        f"{out['gloo_wall_s']:.1f} s with the spawn")
    log(f"  kernel launches on the sharded LM path: {out['launches']}")


# ------------------------------------------------------------- phase 21 --

def strain_cases(tp=LM_STRAIN_TP):
    """Phase 21 (a)'s cases, ``(key, mode, cfg)``: the tensor-parallel
    families at ``reduced()``; every family under "fsdp" at ``reduced()``
    with a vocabulary of 16,384 and ``d_ff`` 16,384 (2,048 per expert), so
    that ZeRO-3 shards the table and the block matrices (the CPU tests'
    configs)."""
    from repro_torch import configs as TC
    out = [(f"tp {shard_key(cfg)}", "tp", cfg) for cfg in shard_families(tp)]
    for a in TC.ARCH_IDS:
        cfg = TC.get(a).reduced()
        out.append((f"fsdp {cfg.name}", "fsdp", dataclasses.replace(
            cfg, vocab=16384, d_ff=2048 if cfg.n_experts else 16384)))
    return out


def strain_run(cfg, device, b, s, steps, base_lr, warmup, mesh=None,
               mode="tp", gen_device="cpu"):
    """``steps`` train steps of ``cfg`` on ``device`` (on ``mesh`` in
    ``mode`` when given), warmup ``warmup``, on ``SyntheticLM`` batches;
    the masters drawn from a generator of seed 0 on ``gen_device`` (each
    rank keeps its shards of the one-device draw). Returns (model, state,
    {"metrics": each step's as floats, "g0": step 0's gradients, the
    rank's shards, summed over the ranks; "step_s": each step's seconds,
    host clock to a synchronize; "collectives", "staged_bytes": of the
    steps, from ``dist.comm.STATS``})."""
    import torch
    from repro_torch.dist import comm
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_train_state
    model = build_model(cfg, device=device, mesh=mesh, mode=mode)
    state = init_train_state(model, torch.Generator(device=gen_device)
                             .manual_seed(0))
    step = make_train_step(model, base_lr=base_lr, warmup=warmup,
                           total_steps=steps)
    pipe = train_pipe(cfg, device, b, s)
    g0, _ = step.gradients(state, pipe.batch(0))
    metrics, step_s = [], []
    comm.reset_stats()
    for i in range(steps):
        sync(device)
        t0 = time.perf_counter()
        m = step(state, pipe.batch(i))[1]
        sync(device)
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state, dict(metrics=metrics, g0=g0, step_s=step_s,
                              **comm.STATS)


def strain_whole(model, state, g0):
    """Step 0's gradients, the masters and both moments, every leaf whole
    (gathered over the model's mesh: every rank takes part)."""
    from repro_torch.launch.sharding import gather_tensor

    def whole(n, t):
        spec = model.spec_of(n)
        t = t.detach()
        return t if spec is None else gather_tensor(t, spec, model.mesh)
    return {f"{w}/{n}": whole(n, t) for w, tree in (
        ("g0", g0), ("params", state.params), ("mu", state.opt.mu),
        ("nu", state.opt.nu)) for n, t in tree.items()}


def strain_err(name, metrics, whole, ref_metrics, ref_whole,
               tol=LM_TOL) -> dict:
    """Raise unless every step's metrics are within ``tol`` of the
    reference's (``grad_norm`` relative) and every leaf of ``whole`` within
    ``tol`` of the reference leaf's largest magnitude; the worst of both."""
    worst = 0.0
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        for k, v in r.items():
            err = abs(m[k] - v) / (max(1.0, abs(v)) if k == "grad_norm"
                                   else 1.0)
            if not err <= tol:
                raise AssertionError(f"{name} step {i} {k}: {m[k]} vs "
                                     f"{v}, beyond {tol}")
            worst = max(worst, err)
    leaf = max(rel_err(f"{name} {k}", t, ref_whole[k].cpu(), tol)
               for k, t in whole.items())
    return dict(metric_err=worst, leaf_err=leaf)


def strain_same(name, got, want) -> None:
    """Raise unless two ``strain_run``s (their results and states) are
    bitwise equal."""
    import torch
    (gs, gr), (ws, wr) = got, want
    if gr["metrics"] != wr["metrics"]:
        raise AssertionError(f"{name}: metrics differ")
    differ = [n for n, g in wr["g0"].items()
              if not torch.equal(gr["g0"][n], g)]
    if differ:
        raise AssertionError(f"{name}: step 0 gradients differ at "
                             f"{differ[:3]}")
    same_state(name, gs, ws)


def digest(t) -> str:
    """A hash of a tensor's bits."""
    import hashlib
    import torch
    return hashlib.sha1(t.detach().reshape(-1).contiguous().view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def ranks_agree(name, model, state, metrics) -> int:
    """Raise unless every rank holds bitwise the same metrics and the same
    bits of every master it holds whole (replicated over the mesh); returns
    how many such masters were compared."""
    import torch.distributed as dist
    shapes = model.param_specs()
    mine = (metrics, {n: digest(t) for n, t in state.params.items()
                      if tuple(t.shape) == tuple(shapes[n].shape)})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if any(e != every[0] for e in every[1:]):
        raise AssertionError(f"{name}: the ranks' metrics or replicated "
                             "masters differ")
    return len(mine[1])


def strain_eval(model, state, pipe, n):
    """The loss of batches ``0..n-1`` on the masters (no update)."""
    import torch
    from repro_torch.train.step import compute_params
    with torch.no_grad():
        return [float(model.forward_train(
            compute_params(model, state.params), pipe.batch(i),
            remat=False)[0]) for i in range(n)]


def strain_full(cfg, device, b, s, steps, base_lr, warmup):
    """Phase 21 (c) in one rank: ``cfg`` on the mesh over every rank's
    "model" axis, tensor-parallel, masters drawn on the card; the eval
    loss of batches 0..2 before and after, each step timed by CUDA events
    (a host clock off the card) with its collectives and staged bytes, the
    state's bytes and the peak, the ranks' replicated masters compared."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import comm
    from repro_torch.ft import ElasticMesh
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_train_state
    on_card = device.type == "cuda"
    mesh = ElasticMesh(dist.get_world_size(), device=device).current()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, mesh=mesh)
    state = init_train_state(model, torch.Generator(device=device)
                             .manual_seed(0))
    sync(device)
    out = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               dispatch=cfg.moe_dispatch, b=b, s=s, steps=steps,
               base_lr=base_lr, warmup=warmup, mesh=tuple(mesh.mesh.shape),
               init_s=time.perf_counter() - t0,
               transport=comm.transport(mesh.get_group("model"), device))
    shapes = model.param_specs()
    whole = sum(math.prod(sp.shape) for sp in shapes.values())
    held = sum(t.numel() * t.element_size() for tree in (
        state.params, state.opt.mu, state.opt.nu) for t in tree.values())
    out.update(params=whole, state_bytes=held,
               one_device_state_bytes=3 * 4 * whole,
               state_share=held / (3 * 4 * whole))
    pipe = train_pipe(cfg, device, b, s)
    step = make_train_step(model, base_lr=base_lr, warmup=warmup,
                           total_steps=steps)
    before = strain_eval(model, state, pipe, LM_TRAIN_EVAL)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ms, per_step, metrics = [], [], []
    for i in range(steps):
        comm.reset_stats()
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t1 = time.perf_counter()
        _, m = step(state, pipe.batch(i))
        if on_card:
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        else:
            ms.append((time.perf_counter() - t1) * 1e3)
        per_step.append(dict(comm.STATS))
        metrics.append({k: float(v) for k, v in m.items()})
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() \
        if on_card else None
    after = strain_eval(model, state, pipe, LM_TRAIN_EVAL)
    out["replicated_masters"] = ranks_agree(f"{cfg.name} (c)", model, state,
                                            metrics)
    losses = [m["loss"] for m in metrics]
    gnorms = [m["grad_norm"] for m in metrics]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"(c) non-finite loss or grad_norm: {losses} "
                             f"{gnorms}")
    if not sum(after) < sum(before):
        raise AssertionError(f"(c) mean loss over batches 0..2 {before} "
                             f"before training, {after} after: not lower")
    if not out["state_share"] <= LM_STRAIN_SHARE:
        raise AssertionError(f"(c) a rank holds {out['state_share']:.3f} "
                             f"of one device's state (limit "
                             f"{LM_STRAIN_SHARE})")
    p50 = percentile(ms, 50)
    out.update(losses=losses, grad_norms=gnorms, eval_before=before,
               eval_after=after,
               eval_drop=(sum(before) - sum(after)) / LM_TRAIN_EVAL,
               step_ms=ms, step_ms_p50=p50, step_ms_p90=percentile(ms, 90),
               tokens_per_s=b * s / (p50 / 1e3),
               collectives_per_step=percentile(
                   [x["collectives"] for x in per_step], 50),
               staged_bytes_per_step=percentile(
                   [x["staged_bytes"] for x in per_step], 50))
    del model, state, step
    return out


def _lm_strain_rank(rank, size, out_dir, device_type, job):
    """One rank of phase 21's gloo world, in its own process, every tensor
    on ``device_type``: (a) each case of ``job["cases"]`` on the meshes
    ``(1, size)`` and ``(size, 1)`` (the "fsdp" cases on the first: over
    both axes they are the same), rank 0 holding one device's run of the
    case beside and checking the gathered results against it, every rank
    checking the ranks agree; (b) ``job["wide"]`` the same on ``(1, size)``,
    in both modes;
    (c) ``strain_full`` of ``job["full"]``. Writes ``rank<r>.pt``."""
    import faulthandler
    import signal
    import traceback
    import torch
    sys.path.insert(0, str(SRC))
    device = torch.device(device_type)
    if device.type != "cuda":
        torch.set_num_threads(1)
    # where a rank stood when it failed or was stopped, for the parent
    stack = open(Path(out_dir) / f"rank{rank}.stack", "w")
    faulthandler.enable(file=stack, all_threads=True)
    faulthandler.register(signal.SIGTERM, file=stack, all_threads=True)
    try:
        _lm_strain_work(rank, size, out_dir, device, job)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise


def _lm_strain_work(rank, size, out_dir, device, job):
    """The body of ``_lm_strain_rank``."""
    import torch
    from repro_torch.ft import ElasticMesh
    out = dict(a={}, wide=None, full=None)
    fam = job["family"]
    with world("gloo", Path(out_dir) / "store", size, rank):
        refs = {}
        for mp_ in (size, 1):
            mesh = ElasticMesh(mp_, device=device).current()
            shape = tuple(mesh.mesh.shape)
            for key, mode, cfg in job["cases"]:
                if mode == "fsdp" and mp_ == 1:
                    continue
                if rank == 0 and key not in refs:
                    m, st, r = strain_run(one_device_cfg(cfg), device, **fam)
                    refs[key] = (r["metrics"], strain_whole(m, st, r["g0"]))
                    del m, st, r
                model, state, run = strain_run(cfg, device, mesh=mesh,
                                               mode=mode, **fam)
                whole = strain_whole(model, state, run["g0"])
                n_rep = ranks_agree(f"{key} {shape}", model, state,
                                    run["metrics"])
                if rank == 0:
                    out["a"][(key, shape)] = dict(
                        strain_err(f"{key} {shape}", run["metrics"], whole,
                                   *refs[key]),
                        replicated_masters=n_rep,
                        collectives_per_step=run["collectives"]
                        / fam["steps"])
                del model, state, run, whole
        refs.clear()
        if job["wide"] is not None:
            cfg, wide = job["wide"]
            kw = {k: v for k, v in wide.items() if k != "layers"}
            mesh = ElasticMesh(size, device=device).current()
            ref = None
            if rank == 0:
                m, st, r = strain_run(one_device_cfg(cfg), device, **kw)
                ref = (r["metrics"], strain_whole(m, st, r["g0"]))
                del m, st, r
            out["wide"] = {}
            for mode in ("tp", "fsdp"):
                model, state, run = strain_run(cfg, device, mesh=mesh,
                                               mode=mode, **kw)
                whole = strain_whole(model, state, run["g0"])
                ranks_agree(f"{cfg.name} (b) {mode}", model, state,
                            run["metrics"])
                if rank == 0:
                    n = kw["steps"]
                    out["wide"][mode] = dict(
                        strain_err(f"{cfg.name} (b) {mode}", run["metrics"],
                                   whole, *ref),
                        arch=cfg.name, layers=cfg.n_layers, b=kw["b"],
                        s=kw["s"], steps=n, loss=run["metrics"][0]["loss"],
                        step_ms_p50=percentile(run["step_s"], 50) * 1e3,
                        collectives_per_step=run["collectives"] / n,
                        staged_bytes_per_step=run["staged_bytes"] / n)
                del model, state, run, whole
            del ref
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if job["full"] is not None:
            cfg, full = job["full"]
            out["full"] = strain_full(cfg, device, **full)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def phase_lm_strain(device, out_dir, cases=None, wide_cfg=None,
                    full_cfg=None, backend="nccl", family=LM_STRAIN_FAMILY,
                    wide=LM_STRAIN_WIDE, full=LM_STRAIN,
                    size=LM_STRAIN_RANKS, timeout_s=LM_STRAIN_TIMEOUT_S):
    """Phase 21, the LM stack's sharded training path: (a) each case of
    ``strain_cases`` on a world of one over ``backend``, in its mode,
    bitwise one device's run (metrics, step 0's gradients, masters and
    moments after the steps), then over ``size`` gloo ranks sharing
    ``device`` within ``LM_TOL`` of one device, ranks bitwise; (b)
    Granite's published widths at ``wide["layers"]`` layers in float32 over
    the ranks, in both modes, within ``LM_TOL``, timed; (c) Granite-MoE 3B
    as published
    (``full_cfg``) trained over the ranks. The BP kernels run nowhere
    here: their counts go from 0."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch import configs as TC
    from repro_torch.ft import ElasticMesh
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    out_dir = Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cases = cases or strain_cases()
    granite = TC.get("granite_moe_3b_a800m")
    wide_cfg = wide_cfg or dataclasses.replace(
        granite, n_layers=wide["layers"], dtype="float32",
        moe_dispatch="sharded")
    full_cfg = full_cfg or dataclasses.replace(granite,
                                               moe_dispatch="sharded")
    out = dict(cases=[k for k, _, _ in cases])
    t0 = time.perf_counter()
    one = {}
    with world(backend, out_dir / "store_one"):
        mesh = ElasticMesh(1, device=device).current()
        for key, mode, cfg in cases:
            a = strain_run(one_device_cfg(cfg), device, **family)
            b = strain_run(cfg, device, mesh=mesh, mode=mode, **family)
            strain_same(f"{key} on a world of one vs one device", b[1:],
                        a[1:])
            one[key] = True
            del a, b
    out["one"] = one
    out["a_one_s"] = time.perf_counter() - t0
    log(f"  (a) one device and a world of one: {out['a_one_s']:.1f} s")

    job = dict(cases=cases, family=family, wide=(wide_cfg, wide),
               full=(full_cfg, full))
    t0 = time.perf_counter()
    ctx = mp.start_processes(_lm_strain_rank, args=(size, str(out_dir),
                                                    device.type, job),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"phase 21's gloo world did not finish "
                                     f"in {timeout_s} s")
    except Exception as e:
        notes = [f"{p.name}:\n{p.read_text()[-3000:]}"
                 for p in sorted(out_dir.glob("rank*.err"))
                 + sorted(out_dir.glob("rank*.stack")) if p.stat().st_size]
        raise AssertionError(f"phase 21's ranks failed: {e}\n"
                             + "\n".join(notes)) from e
    out["gloo_wall_s"] = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(size)]
    shutil.rmtree(out_dir, ignore_errors=True)
    out["families"] = {f"{k} {s[0]}x{s[1]}": v
                       for (k, s), v in ranks[0]["a"].items()}
    out["wide"] = ranks[0]["wide"]
    out["full"] = ranks[0]["full"]
    out["full"]["rank_state_bytes"] = [r["full"]["state_bytes"]
                                       for r in ranks]
    out["full"]["rank_peak_memory_bytes"] = [r["full"]["peak_memory_bytes"]
                                             for r in ranks]
    out["launches"] = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                       "fused_update_e/sum": TT.LAUNCHES["sum"],
                       "fused_update_e/max": TT.LAUNCHES["max"],
                       "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    return out


def log_lm_strain(out) -> None:
    """Phase 21's progress lines."""
    log(f"  (a) world of one: {len(out['one'])} cases bitwise the "
        f"one-device run ({out['a_one_s']:.1f} s)")
    for key, f in out["families"].items():
        log(f"  (a) {key}: vs one device metrics {f['metric_err']:.3g}, "
            f"leaves {f['leaf_err']:.3g} (of max); "
            f"{f['replicated_masters']} replicated masters and the metrics "
            f"bitwise on every rank; {f['collectives_per_step']:.0f} "
            "collectives/step")
    for mode, w in out["wide"].items():
        log(f"  (b) {w['arch']} {w['layers']} layers float32 B={w['b']} "
            f"S={w['s']} {w['steps']} steps over the ranks, {mode}: "
            f"metrics {w['metric_err']:.3g}, gradients, masters and moments "
            f"{w['leaf_err']:.3g} (of max) vs one device; "
            f"{w['step_ms_p50']:.1f} ms/step p50, "
            f"{w['collectives_per_step']:.0f} collectives and "
            f"{w['staged_bytes_per_step']:.0f} B staged per step")
    c = out["full"]
    log(f"  (c) {c['arch']} {c['layers']} layers {c['dtype']} "
        f"({c['dispatch']}) on {c['mesh']} over {c['transport']}: "
        f"{c['params']:,} parameters, drawn in {c['init_s']:.1f} s; state "
        f"{c['rank_state_bytes']} B per rank = {c['state_share']:.3f} of "
        f"one device's {c['one_device_state_bytes']} B; peak "
        f"{c['rank_peak_memory_bytes']} B")
    log(f"  (c) B={c['b']} S={c['s']}: {c['step_ms_p50']:.1f} ms/step p50 "
        f"({c['step_ms_p90']:.1f} p90) = {c['tokens_per_s']:.0f} tokens/s; "
        f"{c['collectives_per_step']:.0f} collectives and "
        f"{c['staged_bytes_per_step']:.0f} B staged per step")
    log("  (c) loss " + ", ".join(f"{x:.4f}" for x in c["losses"])
        + "; grad_norm " + ", ".join(f"{x:.4f}" for x in c["grad_norms"]))
    log(f"  (c) eval loss over batches 0..2: {c['eval_before']} before, "
        f"{c['eval_after']} after (drop {c['eval_drop']:.4f}); "
        f"{c['replicated_masters']} replicated masters bitwise across ranks")
    log(f"  gloo ranks: {out['gloo_wall_s']:.1f} s with the spawn; kernel "
        f"launches on the sharded training path: {out['launches']}")


# ------------------------------------------------------------- phase 22 --

def blocks_wide_cfgs(layers):
    """Phase 22 (b)'s configs: Hymba-1.5B, DeepSeek-V3 and Whisper-medium
    at their published widths, ``layers`` layers (whisper: as many encoder
    layers), float32; DeepSeek's layers dense (no MoE layer), with MTP."""
    from repro_torch import configs as TC
    return [dataclasses.replace(TC.get("hymba_1_5b"), n_layers=layers,
                                dtype="float32"),
            dataclasses.replace(TC.get("deepseek_v3_671b"), n_layers=layers,
                                n_experts=0, experts_per_token=0,
                                n_shared_experts=0, n_dense_layers=0,
                                dtype="float32"),
            dataclasses.replace(TC.get("whisper_medium"), n_layers=layers,
                                n_enc_layers=layers, dtype="float32")]


def blocks_serve_run(cfg, device, b, s, steps, mesh=None):
    """``decode_run`` of ``cfg`` (prefill over ``s`` tokens, ``steps``
    decode steps from ``init_cache``) on ``device`` (on ``mesh`` when
    given), weights from ``init_params`` with a card generator of seed 0,
    tokens from a CPU one."""
    import torch
    model = build_model_on(cfg, device, mesh)
    batch = {k: v.to(device) for k, v in lm_inputs(cfg, b, s).items()}
    toks = torch.randint(0, cfg.vocab, (steps, b, 1),
                         generator=torch.Generator().manual_seed(2))
    out = decode_run(model, batch, toks, s + steps)
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    del model
    return out


def blocks_grads(cfg, device, b, s, mesh=None):
    """Step 0's gradients of ``cfg`` (float32) on ``device`` (on ``mesh``
    when given, each leaf gathered whole): ``forward_train`` on the
    ``SyntheticLM`` batch 0 at (``b``, ``s``), weights from ``init_params``
    with a card generator of seed 0. Returns (metrics as floats, {name:
    whole gradient}, {name: digest of the rank's own gradient} of the
    leaves every rank holds whole)."""
    from repro_torch.launch.sharding import gather_tensor
    model = build_model_on(cfg, device, mesh)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, metrics = model.forward_train(params,
                                        train_pipe(cfg, device, b, s).batch(0))
    loss.backward()
    grads, held = {}, {}
    for n, p in params.items():
        spec = model.spec_of(n)
        g, p.grad = p.grad, None
        if spec is None or not any(spec):
            held[n] = digest(g)
            grads[n] = g
        else:
            grads[n] = gather_tensor(g, spec, model.mesh)
    del model, params, loss
    return {k: float(v.detach()) for k, v in metrics.items()}, grads, held


def sharded_grads(cfg, device, b, s, mesh, tol=None):
    """Step 0's gradients of ``cfg`` on ``mesh`` against one device's, which
    rank 0 computes beside: every rank's metrics and gradients of the
    leaves it holds whole bitwise equal (raises otherwise); on rank 0 the
    worst leaf's max|diff| / max (raises beyond ``tol`` when given) and
    the metrics' largest difference (raises beyond ``LM_METRIC_TOL``)."""
    import torch
    import torch.distributed as dist
    ref = blocks_grads(cfg, device, b, s) if dist.get_rank() == 0 else None
    metrics, grads, held = blocks_grads(cfg, device, b, s, mesh)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (metrics, held))
    if any(e != every[0] for e in every[1:]):
        raise AssertionError(f"{cfg.name}: the ranks' metrics or gradients "
                             "of replicated leaves differ")
    out = dict(replicated_leaves=len(held))
    if ref is not None:
        errs = {n: float((g - ref[1][n]).abs().max()
                         / ref[1][n].abs().max().clamp_min(1e-30))
                for n, g in grads.items()}
        out["grad_leaf"] = max(errs, key=errs.get)
        out["grad_err"] = errs[out["grad_leaf"]]
        if tol is not None and not out["grad_err"] <= tol:
            raise AssertionError(f"{cfg.name} gradient {out['grad_leaf']}: "
                                 f"max|diff| / max = {out['grad_err']:.3g} "
                                 f"beyond {tol}")
        out["metric_err"] = max(abs(metrics[k] - v)
                                for k, v in ref[0].items())
        if not out["metric_err"] <= LM_METRIC_TOL:
            raise AssertionError(f"{cfg.name}: metrics {metrics} vs one "
                                 f"device's {ref[0]}")
    del ref, grads
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def grads_floor(cfg, device, b, s):
    """How far one device's step 0 gradients of ``cfg`` (float32) on
    ``device`` lie from the same model's on the CPU, same weights and
    batch: the worst leaf's max|diff| / max, and that leaf. On the CPU
    (``device`` the CPU) the two runs are one, and the floor is 0."""
    import torch
    from repro_torch.models import build_model
    metrics, grads, _ = blocks_grads(cfg, device, b, s)
    model = build_model_on(cfg, device)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    del model
    params = dict(cpu.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = cpu.forward_train(params, {
        k: v.cpu() for k, v in train_pipe(cfg, device, b, s).batch(0).items()})
    loss.backward()
    errs = {n: float((grads[n].cpu() - p.grad).abs().max()
                     / p.grad.abs().max().clamp_min(1e-30))
            for n, p in params.items()}
    leaf = max(errs, key=errs.get)
    del grads
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(grad_err=errs[leaf], grad_leaf=leaf,
                loss_diff=abs(metrics["loss"] - float(loss.detach())))


def timed_serve(model, b, s, steps):
    """``model`` (bf16) served: a warm ``prefill`` over (``b``, ``s``)
    tokens, then one timed (host clock to a synchronize), and ``steps``
    decode steps continuing from its cache, each timed by CUDA events on
    the card (the host clock off it), with the collectives and the bytes
    staged through the host of the decode steps."""
    import torch
    from repro_torch.dist import comm
    dev = model.device
    on_card = dev.type == "cuda"
    tokens = torch.randint(0, model.cfg.vocab, (b, s + steps),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    model.prefill({"tokens": tokens[:, :s]})            # warm
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": tokens[:, :s]})
    sync(dev)
    prefill_s = time.perf_counter() - t0
    pos = torch.full((), s, dtype=torch.int64, device=dev)
    comm.reset_stats()
    step_ms, out = [], [logits.cpu()]
    for t in range(steps):
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t1 = time.perf_counter()
        lg, cache = model.decode_step(cache, tokens[:, s + t:s + t + 1], pos)
        if on_card:
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
        else:
            step_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(lg.cpu())
        pos = pos + 1
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError(f"{model.cfg.name}: non-finite logits")
    cache_bytes = sum(t.numel() * t.element_size() for g in cache.values()
                      for t in g.values())
    return dict(prefill_s=prefill_s, prefill_tokens_per_s=b * s / prefill_s,
                step_ms=step_ms, logits=out, cache_bytes=cache_bytes,
                collectives=comm.STATS["collectives"],
                staged_bytes=comm.STATS["staged_bytes"])


def blocks_decode_bound(cfg, b, bw):
    """The least time of one decode step of ``cfg`` at batch ``b`` on a
    card of ``bw`` bytes/s: every weight read once (of an untied embedding
    table only the ``b`` rows looked up, neglected), the decode state read
    once and written once."""
    from repro_torch.models.model import Model, param_specs
    weights = sum(math.prod(sp.shape) * sp.dtype.itemsize
                  for n, sp in param_specs(cfg).items()
                  if cfg.tie_embeddings or n != "embed.table")
    state = sum(math.prod(sp.shape) * sp.dtype.itemsize
                for g in Model(cfg, device="meta").init_cache_specs(
                    b, 1).values() for sp in g.values())
    return dict(bytes=weights + 2 * state, weight_bytes=weights,
                state_bytes=state, decode_ms=(weights + 2 * state) / bw * 1e3,
                bound_by="bytes")


def _lm_blocks_rank(rank, size, out_dir, device_type, job):
    """One rank of phase 22's gloo world, in its own process, every tensor
    on ``device_type``; a failing rank leaves its traceback and stack
    beside its results. Writes ``rank<r>.pt``."""
    import faulthandler
    import signal
    import traceback
    import torch
    sys.path.insert(0, str(SRC))
    device = torch.device(device_type)
    if device.type != "cuda":
        torch.set_num_threads(1)
    stack = open(Path(out_dir) / f"rank{rank}.stack", "w")
    faulthandler.enable(file=stack, all_threads=True)
    faulthandler.register(signal.SIGTERM, file=stack, all_threads=True)
    try:
        _lm_blocks_work(rank, size, out_dir, device, job)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise


def _lm_blocks_work(rank, size, out_dir, device, job):
    """Phase 22 in one rank, on the mesh ``(1, size)``: (a) Mamba2 in
    float32 served (results kept for the parent) and trained (rank 0 holds
    one device's run beside and checks against it, every rank checks the
    ranks agree), in bf16 served and timed, and trained (``strain_full``);
    (b) each wide config served (kept for the parent) and its step 0's
    gradients against one device's, which rank 0 computes beside."""
    import torch
    from repro_torch.ft import ElasticMesh
    out = dict(f32=None, train=None, bf16=None, full=None, wide={},
               seconds={})
    t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        out["seconds"][part] = time.perf_counter() - t0
        t0 = time.perf_counter()
    with world("gloo", Path(out_dir) / "store", size, rank):
        mesh = ElasticMesh(size, device=device).current()
        cfg = job["mamba"]
        f32 = dataclasses.replace(cfg, dtype="float32")
        f = job["f32"]
        out["f32"] = dict(blocks_serve_run(f32, device, f["b"], f["s"],
                                           f["steps"], mesh),
                          coord=tuple(mesh.get_coordinate()))
        lap("f32 served")
        out["grads"] = sharded_grads(f32, device, mesh=mesh,
                                     **job["f32_grads"])
        lap("f32 step 0 gradients")
        t = dict(job["f32_train"])
        f32 = dataclasses.replace(f32, n_layers=t.pop("layers"))
        ref = None
        if rank == 0:
            m, st, r = strain_run(f32, device, **t, gen_device=device.type)
            ref = (r["metrics"], strain_whole(m, st, r["g0"]))
            del m, st, r
        model, state, run = strain_run(f32, device, mesh=mesh, **t,
                                       gen_device=device.type)
        whole = strain_whole(model, state, run["g0"])
        n_rep = ranks_agree(f"{f32.name} float32 train", model, state,
                            run["metrics"])
        if rank == 0:
            out["train"] = dict(strain_err(f"{f32.name} float32 train",
                                           run["metrics"], whole, *ref),
                                replicated_masters=n_rep,
                                collectives_per_step=run["collectives"]
                                / t["steps"],
                                staged_bytes_per_step=run["staged_bytes"]
                                / t["steps"])
        del model, state, run, whole, ref
        lap("f32 train steps")
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sv = job["serve"]
        model = build_model_on(cfg, device, mesh)
        out["bf16"] = dict(timed_serve(model, sv["b"], sv["s"], sv["steps"]),
                           param_bytes=sum(p.numel() * p.element_size()
                                           for p in model.parameters()),
                           peak_memory_bytes=torch.cuda.max_memory_allocated()
                           if device.type == "cuda" else None)
        del model
        lap("bf16 served")
        out["full"] = strain_full(cfg, device, **job["train"])
        lap("bf16 trained")
        wide = job["wide"]
        for wcfg in job["wide_cfgs"]:
            got = blocks_serve_run(wcfg, device, wide["b"], wide["s"],
                                   wide["steps"], mesh)
            got.update(sharded_grads(wcfg, device, wide["b"], wide["s"], mesh,
                                     tol=LM_TOL),
                       coord=tuple(mesh.get_coordinate()))
            out["wide"][wcfg.name] = got
            lap(wcfg.name)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def build_model_on(cfg, device, mesh=None):
    """``cfg``'s model on ``device`` (on ``mesh`` when given), weights
    from ``init_params`` with a card generator of seed 0."""
    import torch
    from repro_torch.models import build_model
    return build_model(cfg, device=device, mesh=mesh).init_params(
        torch.Generator(device=device).manual_seed(0))


def check_served(name, ranks, key, ref, mesh_shape):
    """A run that the ranks kept (``ranks[r][key]``) within ``LM_TOL`` of
    one device's ``ref`` (logits elementwise, abs and rel), the ranks'
    logits bitwise equal, every rank's cache blocks their slices of one
    device's caches within ``LM_TOL`` of each leaf's largest magnitude (a
    state summed over 1,024 tokens reaches tens); the worst errors."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import shard_tensor
    run = ranks[0][key] if not isinstance(key, tuple) else \
        ranks[0][key[0]][key[1]]
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    errs = [lm_err(f"{name} prefill", run["logits"], ref["logits"])]
    errs += [lm_err(f"{name} step {t}", a, c)
             for t, (a, c) in enumerate(zip(run["steps"], ref["steps"]))]
    cache_err = 0.0
    for r in ranks:
        mine = r[key] if not isinstance(key, tuple) else r[key[0]][key[1]]
        same_run(f"{name} rank vs rank 0",
                 dict(logits=mine["logits"], steps=mine["steps"]),
                 dict(logits=run["logits"], steps=run["steps"]))
        for which, specs in (("cache", "specs"), ("dcache", "dspecs")):
            for g, leaves in ref[which].items():
                for k, v in leaves.items():
                    cache_err = max(cache_err, rel_err(
                        f"{name} {which} {g}/{k} block", mine[which][g][k],
                        shard_tensor(v, mine[specs][g][k], mesh,
                                     coordinate=mine["coord"]), LM_TOL,
                        scale=v.abs().max()))
    return dict(err=max(errs), cache_err=cache_err,
                collectives_per_step=run["collectives"]
                / max(len(run["steps"]), 1),
                staged_bytes_per_step=run["staged_bytes"]
                / max(len(run["steps"]), 1))


def phase_lm_blocks(device, out_dir, bw=3.35e12, mamba_cfg=None,
                    wide_cfgs=None, backend="nccl", f32=LM_BLOCKS_F32,
                    f32_grads=LM_BLOCKS_F32_GRADS,
                    f32_train=LM_BLOCKS_F32_TRAIN, serve=LM_BLOCKS_SERVE,
                    train=LM_BLOCKS_TRAIN, wide=LM_BLOCKS_WIDE,
                    size=LM_BLOCKS_RANKS, timeout_s=LM_BLOCKS_TIMEOUT_S):
    """Phase 22, tensor parallelism of the SSM, hybrid, MLA and
    encoder-decoder blocks over ``size`` gloo ranks sharing ``device`` at
    ``(1, size)``: one device's runs of Mamba2 in float32 (``mamba_cfg``,
    the published config) and of the wide configs served, and Mamba2's on
    a world of one over ``backend`` bitwise them (served, and trained at
    ``f32_train["layers"]`` layers); the floor of Mamba2's step 0
    gradients (one device on ``device`` against the CPU); then the ranks
    (``_lm_blocks_work``), their served runs held here to one device's
    within ``LM_TOL``, ranks bitwise, cache blocks the slices, their step
    0 gradients at full depth to the floor. The BP kernels run nowhere
    here: their counts go from 0."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch import configs as TC
    from repro_torch.ft import ElasticMesh
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.models.model import param_specs
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    out_dir = Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cfg = mamba_cfg or TC.get("mamba2_130m")
    wide_cfgs = wide_cfgs or blocks_wide_cfgs(wide["layers"])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=sum(
        math.prod(sp.shape) for sp in param_specs(cfg).values()))
    t0 = time.perf_counter()
    ref = blocks_serve_run(cfg32, device, **f32)
    wrefs = {w.name: blocks_serve_run(w, device, wide["b"], wide["s"],
                                      wide["steps"]) for w in wide_cfgs}
    floor = grads_floor(cfg32, device, **f32_grads)
    t = dict(f32_train)
    short = dataclasses.replace(cfg32, n_layers=t.pop("layers"))
    with world(backend, out_dir / "store_one"):
        mesh = ElasticMesh(1, device=device).current()
        same_run(f"{cfg.name} float32 on a world of one vs one device",
                 blocks_serve_run(cfg32, device, mesh=mesh, **f32), ref)
        a = strain_run(short, device, **t, gen_device=device.type)
        b = strain_run(short, device, mesh=mesh, **t,
                       gen_device=device.type)
        strain_same(f"{cfg.name} float32 train on a world of one vs one "
                    "device", b[1:], a[1:])
        del a, b
    out["world_of_one_bitwise"] = True
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["one_s"] = time.perf_counter() - t0
    log(f"  one device and a world of one: {out['one_s']:.1f} s")

    job = dict(mamba=cfg, f32=f32, f32_grads=f32_grads,
               f32_train=f32_train, serve=serve,
               train=train, wide=wide, wide_cfgs=wide_cfgs)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_lm_blocks_rank, args=(size, str(out_dir),
                                                    device.type, job),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"phase 22's gloo world did not finish "
                                     f"in {timeout_s} s")
    except Exception as e:
        notes = [f"{p.name}:\n{p.read_text()[-3000:]}"
                 for p in sorted(out_dir.glob("rank*.err"))
                 + sorted(out_dir.glob("rank*.stack")) if p.stat().st_size]
        raise AssertionError(f"phase 22's ranks failed: {e}\n"
                             + "\n".join(notes)) from e
    out["gloo_wall_s"] = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(size)]
    shutil.rmtree(out_dir, ignore_errors=True)
    shape = (1, size)
    out["rank0_seconds"] = ranks[0]["seconds"]

    out["f32"] = dict(check_served(f"{cfg.name} float32", ranks, "f32", ref,
                                   shape), **f32)
    g = ranks[0]["grads"]
    if not g["grad_err"] <= max(floor["grad_err"], LM_TOL):
        raise AssertionError(
            f"{cfg.name} float32 step 0 gradients over the ranks: "
            f"{g['grad_leaf']} {g['grad_err']:.3g} of max from one device, "
            f"beyond the larger of {LM_TOL} and one device's own floor "
            f"against the CPU ({floor['grad_leaf']} {floor['grad_err']:.3g})")
    out["grads"] = dict(g, floor=floor, **f32_grads)
    out["train"] = dict(ranks[0]["train"], **f32_train)
    bf = [r["bf16"] for r in ranks]
    for r in bf[1:]:
        same_run(f"{cfg.name} bf16 rank vs rank 0",
                 dict(logits=r["logits"][0], steps=r["logits"][1:]),
                 dict(logits=bf[0]["logits"][0], steps=bf[0]["logits"][1:]))
    n = serve["steps"]
    bound = blocks_decode_bound(cfg, serve["b"], bw)
    out["bf16"] = dict(
        b=serve["b"], s=serve["s"], steps=n,
        transport=ranks[0]["full"]["transport"],
        prefill_s=bf[0]["prefill_s"],
        prefill_tokens_per_s=bf[0]["prefill_tokens_per_s"],
        decode_step_ms_p50=percentile(bf[0]["step_ms"], 50),
        decode_step_ms_p90=percentile(bf[0]["step_ms"], 90),
        bound=bound, collectives_per_step=bf[0]["collectives"] / n,
        staged_bytes_per_step=bf[0]["staged_bytes"] / n,
        rank_param_bytes=[r["param_bytes"] for r in bf],
        rank_peak_memory_bytes=[r["peak_memory_bytes"] for r in bf])
    out["full"] = ranks[0]["full"]
    out["full"]["rank_state_bytes"] = [r["full"]["state_bytes"]
                                       for r in ranks]
    out["full"]["rank_peak_memory_bytes"] = [r["full"]["peak_memory_bytes"]
                                             for r in ranks]
    out["wide"] = {}
    for w in wide_cfgs:
        got = check_served(w.name, ranks, ("wide", w.name), wrefs[w.name],
                           shape)
        r0 = ranks[0]["wide"][w.name]
        out["wide"][w.name] = dict(got, layers=w.n_layers,
                                   grad_err=r0["grad_err"],
                                   metric_err=r0["metric_err"],
                                   replicated_leaves=r0["replicated_leaves"],
                                   **{k: v for k, v in wide.items()
                                      if k != "layers"})
    out["launches"] = {"fused_update_t/sum": MU.LAUNCHES["sum"],
                       "fused_update_e/sum": TT.LAUNCHES["sum"],
                       "fused_update_e/max": TT.LAUNCHES["max"],
                       "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    return out


def log_lm_blocks(out) -> None:
    """Phase 22's progress lines."""
    f = out["f32"]
    log(f"  (a) {out['arch']} {out['layers']} layers, {out['params']:,} "
        f"parameters; world of one bitwise one device: "
        f"{out['world_of_one_bitwise']}")
    log(f"  (a) float32 B={f['b']} prefill {f['s']} + {f['steps']} decode "
        f"steps over the ranks vs one device {f['err']:.3g}, cache blocks "
        f"{f['cache_err']:.3g} (of max); {f['collectives_per_step']:.0f} "
        "collectives "
        f"and {f['staged_bytes_per_step']:.0f} B staged per decode step; "
        "ranks bitwise")
    g = out["grads"]
    log(f"  (a) float32 step 0 gradients B={g['b']} S={g['s']} over the ranks "
        f"vs one device: worst leaf {g['grad_leaf']} {g['grad_err']:.3g} (of "
        f"max), metrics {g['metric_err']:.3g}; one device on the card vs the "
        f"CPU: {g['floor']['grad_leaf']} {g['floor']['grad_err']:.3g}, loss "
        f"{g['floor']['loss_diff']:.3g}; {g['replicated_leaves']} replicated "
        "leaves' gradients bitwise across ranks")
    t = out["train"]
    log(f"  (a) float32 at {t['layers']} layers B={t['b']} S={t['s']}, "
        f"{t['steps']} train steps vs one device: metrics "
        f"{t['metric_err']:.3g}, leaves {t['leaf_err']:.3g} (of max); "
        f"{t['replicated_masters']} replicated masters bitwise; "
        f"{t['collectives_per_step']:.0f} collectives and "
        f"{t['staged_bytes_per_step']:.0f} B staged per step")
    b = out["bf16"]
    log(f"  (a) bf16 over {b['transport']}: prefill B={b['b']} x {b['s']}: "
        f"{b['prefill_tokens_per_s']:.0f} tokens/s ({b['prefill_s']:.4f} "
        f"s); decode ms/step p50 {b['decode_step_ms_p50']:.3f} p90 "
        f"{b['decode_step_ms_p90']:.3f} (CUDA events) against a bound of "
        f"{b['bound']['decode_ms']:.4f} ms ({b['bound']['bytes']} B); "
        f"{b['collectives_per_step']:.0f} collectives and "
        f"{b['staged_bytes_per_step']:.0f} B staged per step; rank "
        f"parameter bytes {b['rank_param_bytes']}, peaks "
        f"{b['rank_peak_memory_bytes']}")
    c = out["full"]
    log(f"  (a) bf16 over float32 masters, B={c['b']} S={c['s']}: "
        f"{c['step_ms_p50']:.1f} ms/step p50 ({c['step_ms_p90']:.1f} p90) "
        f"= {c['tokens_per_s']:.0f} tokens/s; state {c['rank_state_bytes']} "
        f"B per rank = {c['state_share']:.3f} of one device's; peak "
        f"{c['rank_peak_memory_bytes']} B; {c['collectives_per_step']:.0f} "
        f"collectives and {c['staged_bytes_per_step']:.0f} B staged per step")
    log(f"  (a) eval loss over batches 0..2: {c['eval_before']} before, "
        f"{c['eval_after']} after (drop {c['eval_drop']:.4f})")
    for name, w in out["wide"].items():
        log(f"  (b) {name} {w['layers']} layers float32 B={w['b']} prefill "
            f"{w['s']} + {w['steps']} steps vs one device {w['err']:.3g}, "
            f"cache blocks {w['cache_err']:.3g} (of max), step 0 gradients "
            f"{w['grad_err']:.3g} (of max), metrics {w['metric_err']:.3g}; "
            f"{w['collectives_per_step']:.0f} collectives/decode step; "
            "ranks bitwise")
    log(f"  gloo ranks: {out['gloo_wall_s']:.1f} s with the spawn ("
        + ", ".join(f"{k} {v:.1f}" for k, v in out["rank0_seconds"].items())
        + f" s on rank 0); kernel launches on the path: {out['launches']}")


# ------------------------------------------------------------- phase 23 --

def sub_config(max_rounds):
    """Phase 14's config minus the backend: RnBP at eps 1e-3."""
    return dict(scheduler_kwargs=MAIN_KW, eps=1e-3, max_rounds=max_rounds)


def skew_stream(device, fast_n):
    """Phase 15's skewed stream (``skew_run``): the straggler, then the
    fast grid ``fast_n + 1`` times, built on ``device``."""
    from repro_torch.pgm import ising_grid
    fast = ising_grid(6, 1.5, seed=0, device=device)
    return [ising_grid(6, 3.5, seed=100, device=device), fast] + \
        [fast] * fast_n


def record_rows(records):
    """Per record: rid, status, rounds, the digests of its result, latency
    and the replica (routed records)."""
    rows = []
    for r in records:
        rec = getattr(r, "record", r)
        rows.append(dict(rid=rec.rid, status=rec.status,
                         rounds=int(rec.result.rounds),
                         digests=result_digests(rec.result),
                         latency_s=r.latency_s,
                         replica=getattr(r, "replica", None),
                         stolen=getattr(r, "stolen", False)))
    return rows


def watch_submesh():
    """Hooks on the sub-mesh runs; call the returned ``undo`` after. The
    operands of the last ``slice_update`` call per shape (``captured``;
    ``stash()`` moves them to the host, so that they do not stay on the
    card through later runs), the stepped cycles (``cycles``:
    ``ServingPipeline._step`` calls) and, on a leader in another process
    than the front, the records it sent there (``sent``: count, the
    tensors' bytes, host ms of the copy off the card, the pickle and the
    send)."""
    import torch
    from repro_torch import dist as D
    from repro_torch.core.serving import ServingPipeline as P
    from repro_torch.serve.replica import _FrontLink as L
    w = dict(captured={}, cycles=0,
             sent=dict(records=0, tensor_bytes=0, ms=0.0))
    saved_slice, saved_step, saved_emit = D.slice_update, P._step, L.emit

    def captured(*args):
        w["captured"][tuple(args[2].shape)] = args
        return saved_slice(*args)

    def stepped(self, resident):
        w["cycles"] += 1
        return saved_step(self, resident)

    def emitted(self, rec):
        t0 = time.perf_counter()
        saved_emit(self, rec)
        sent = w["sent"]
        sent["ms"] += (time.perf_counter() - t0) * 1e3
        sent["records"] += 1
        res = rec.record.result
        sent["tensor_bytes"] += sum(
            getattr(res, f.name).nbytes for f in dataclasses.fields(res)
            if isinstance(getattr(res, f.name), torch.Tensor))

    def stash():
        w["captured"] = {k: tuple(a.cpu() if isinstance(a, torch.Tensor)
                                  else a for a in args)
                         for k, args in w["captured"].items()}
    w["stash"] = stash
    D.slice_update, P._step, L.emit = captured, stepped, emitted

    def undo():
        D.slice_update, P._step, L.emit = saved_slice, saved_step, saved_emit
    return w, undo


def _submesh_run(name, fn, device, watch, out):
    """Run ``fn()`` -- one serving run of this rank -- with the launch
    counts, the comm counters, the cycle count, the records sent to the
    front and the card's peak memory reset just before and read just
    after: ``out[name]`` gets its rows and numbers. The captured kernel
    operands go to the host after it."""
    import numpy as np
    import torch
    from repro_torch import dist as D
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import triton_update as TT
    cuda = device.type == "cuda"
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    TT.reset_launch_counts()
    EP.reset_launch_counts()
    D.comm.reset_stats()
    watch["cycles"] = 0
    watch["sent"] = dict(records=0, tensor_bytes=0, ms=0.0)
    t0 = time.perf_counter()
    rep = fn()
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    watch["stash"]()
    st = D.comm.STATS
    cycles = watch["cycles"]
    recs = rep.records
    out[name] = dict(
        rows=record_rows(recs), wall_s=wall, cycles=cycles,
        requests_per_s=len(recs) / wall if recs else 0.0,
        launches=TT.LAUNCHES["sum"],
        prelude_launches=EP.LAUNCHES["edge_prelude"],
        collectives=st["collectives"],
        staged_bytes=st["staged_bytes"], decisions=st["decisions"],
        decision_bytes=st["decision_bytes"], decision_ms=st["decision_ms"],
        # two a stepped cycle, and one at the end
        decisions_per_cycle=(st["decisions"] - 1) / max(cycles, 1)
        if st["decisions"] else 0.0,
        ms_per_cycle=wall * 1e3 / max(cycles, 1), peak_memory_bytes=peak,
        sent_to_front=dict(watch["sent"]))
    stats = getattr(rep, "stats", None)
    if hasattr(stats, "steals"):
        out[name].update(routed=list(stats.routed), steals=stats.steals,
                         stolen=stats.stolen)
    if recs:
        lat = np.array([r.latency_s for r in recs]) * 1e3
        out[name]["latency_ms"] = {"p50": float(np.percentile(lat, 50)),
                                   "p99": float(np.percentile(lat, 99))}
    return rep


def _submesh_rank(rank, size, out_dir, device_type, job):
    """One rank of phase 23, in its own process: the sub-meshes of
    ``job["meshes"]`` over a gloo world of ``size``, every tensor on
    ``device_type``. Rank 0 first runs the one-device ``"triton"``
    yardsticks; then (a) ``serve_async`` on the first sub-mesh (windowed
    admission on the wall clock, two ingest threads), (b) round robin
    through ``serve_routed`` over both, each sub-mesh's share alone, and
    ``least_loaded`` with stealing on the skewed stream. Then
    ``fused_update_e`` against its plain version on the last captured
    slice of each shape. Writes ``out_dir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch import dist as D
    from repro_torch.core import BPConfig, BPEngine, serve_async
    from repro_torch.pgm import stereo_mrf
    from repro_torch.serve import serve_routed
    device = torch.device(device_type)
    cuda = device.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    host = torch.device("cpu")
    scene, frames, zoo_n = job["scene"], job["frames"], job["zoo_n"]
    cfg = sub_config(job["max_rounds"])
    skew_cfg = dict(eps=SKEW_EPS, max_rounds=SKEW_ROUNDS, history=False)
    out = dict(rank=rank)
    t_start = time.perf_counter()
    with world("gloo", Path(out_dir) / "store", size, rank):
        meshes = [D.make_bp_mesh(ranks=r, device=device)
                  for r in job["meshes"]]
        k = next(i for i, m in enumerate(meshes) if m.member)
        out.update(replica=k, leader=meshes[k].ranks[0] == rank,
                   transport=D.comm.transport(meshes[k].group, device))
        scenes = [stereo_mrf(scene["height"], scene["width"],
                             scene["n_disp"], seed=s, device=host).pgm
                  for s in range(frames)]
        out["setup_s"] = time.perf_counter() - t_start

        def stream():
            return serving_stream(scenes, zoo_n, host)

        def skewed():
            items = skew_stream(device, job["skew_fast"])

            def held():
                yield from items
                time.sleep(job["skew_hold"])
            return held()
        if rank == 0:       # the yardsticks, on one device
            t0 = time.perf_counter()
            one = BPEngine(BPConfig(scheduler="rnbp", backend=(
                "triton" if cuda else "ref"),
                batch_backend="triton" if cuda else None, **cfg),
                device=device)
            rep = serve_async(one, stream(), 0, **SERVE_KW)
            out["yardstick"] = record_rows(rep.records)
            one = BPEngine(BPConfig(scheduler="lbp", backend=(
                "triton" if cuda else "ref"), **skew_cfg), device=device)
            rep = serve_async(one, iter(skew_stream(device,
                                                    job["skew_fast"])),
                              0, max_batch=2, chunk_rounds=16)
            out["skew_yardstick"] = record_rows(rep.records)
            out["yardstick_s"] = time.perf_counter() - t0
            del one, rep
        engines = [D.make_sharded_engine("rnbp", m, device=device, **cfg)
                   for m in meshes]
        watch, undo = watch_submesh()
        try:
            # every run starts on every rank together (its timers too)
            dist.barrier()
            if k == 0:      # (a) one sub-mesh, wall-clock decisions
                _submesh_run("a", lambda: serve_async(
                    engines[0], stream(), 0, admission="windowed",
                    **SERVE_KW), device, watch, out)
            dist.barrier()
            _submesh_run("rr", lambda: serve_routed(
                engines, stream(), 0, routing="round_robin", steal=False,
                **ROUTER_KW), device, watch, out)
            share = [it for it in enumerate(stream()) if it[0] % 2 == k]
            dist.barrier()
            _submesh_run("solo", lambda: serve_async(
                engines[k], iter(share), 0, **ROUTER_KW), device, watch,
                out)
            del share
            skew_engines = [D.make_sharded_engine("lbp", m, device=device,
                                                  **skew_cfg)
                            for m in meshes]
            dist.barrier()
            _submesh_run("ll", lambda: serve_routed(
                skew_engines, skewed(), 0, routing="least_loaded",
                steal=True, **SKEW_KW), device, watch, out)
        finally:
            undo()
        out["kernel_check"] = [
            check_slice(tuple(a.to(device) if isinstance(a, torch.Tensor)
                              else a for a in args))
            for _, args in sorted(watch["captured"].items())]
        out["seconds"] = time.perf_counter() - t_start
        dist.barrier()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def check_submesh(ranks, meshes, n, n_skew, stereo, cuda):
    """Phase 23's checks on the ranks' reports (see ``phase_submesh``;
    ``stereo``: the frames' rids); raises on the first that fails."""
    def rows_by_rid(rows):
        return {r["rid"]: r for r in rows}
    yard = rows_by_rid(ranks[0]["yardstick"])
    skew_yard = rows_by_rid(ranks[0]["skew_yardstick"])

    def bitwise(label, rows, want, skip_evicted=False):
        for r in rows:
            if skip_evicted and r["status"] == "evicted":
                continue
            if r["digests"] != want[r["rid"]]["digests"]:
                raise AssertionError(f"phase 23 {label}: request {r['rid']} "
                                     "differs from the one-device run")

    group = [ranks[i] for i in meshes[0]]
    a = [r["a"] for r in group]
    key = [(x["rid"], x["status"], x["rounds"]) for x in a[0]["rows"]]
    if sorted(x[0] for x in key) != list(range(n)):
        raise AssertionError(f"(a) released {sorted(x[0] for x in key)}")
    for other in a[1:]:
        if [(x["rid"], x["status"], x["rounds"])
                for x in other["rows"]] != key or \
                [x["digests"] for x in other["rows"]] != \
                [x["digests"] for x in a[0]["rows"]]:
            raise AssertionError("(a) the ranks of the sub-mesh yielded "
                                 "different records")
        if other["cycles"] != a[0]["cycles"]:
            raise AssertionError("(a) the ranks stepped different cycles")
    bitwise("(a)", a[0]["rows"], yard)
    for r in a:
        if r["decisions"] != 2 * r["cycles"] + 1:
            raise AssertionError(f"(a) {r['decisions']} decision broadcasts "
                                 f"over {r['cycles']} cycles")
    front = ranks[0]["rr"]
    if sorted(r["rid"] for r in front["rows"]) != list(range(n)):
        raise AssertionError("(b) round robin: not every rid released once")
    if front["routed"] != [n - n // 2, n // 2] or front["steals"]:
        raise AssertionError(f"(b) round robin routed {front['routed']}, "
                             f"{front['steals']} steals")
    bitwise("(b) round robin", front["rows"], yard)
    by_rid = rows_by_rid(front["rows"])
    served = {by_rid[rid]["replica"] for rid in stereo}
    if served != set(range(len(meshes))):
        raise AssertionError(f"(b) round robin: stereo frames {stereo} went "
                             f"to replicas {sorted(served)} only")
    for k, group in enumerate(meshes):
        mine = sorted(r["rid"] for r in front["rows"] if r["replica"] == k)
        for i in group:
            rows = ranks[i]["rr"]["rows"]
            if i and sorted(r["rid"] for r in rows) != mine:
                raise AssertionError(f"(b) rank {i} holds records of other "
                                     "replicas")   # the front holds all
            bitwise(f"(b) rank {i}", rows, by_rid)
            solo = ranks[i]["solo"]["rows"]
            if sorted(r["rid"] for r in solo) != list(range(k, n, 2)):
                raise AssertionError(f"(b) rank {i}'s solo share")
            bitwise(f"(b) share {k} solo", solo, by_rid)
    ll = ranks[0]["ll"]
    if sorted(r["rid"] for r in ll["rows"]) != list(range(n_skew)):
        raise AssertionError("(b) least_loaded: not every rid released once")
    if ll["steals"] < 1:
        raise AssertionError("(b) least_loaded with stealing: no steal")
    bitwise("(b) least_loaded", ll["rows"], skew_yard)
    worst = 0.0
    for r in ranks:
        for name in ("rr", "solo", "ll") + (("a",) if "a" in r else ()):
            if cuda and r[name]["launches"] < 1:
                raise AssertionError(f"phase 23 rank {r['rank']} {name}: no "
                                     "fused_update_e launch")
        for row in r["kernel_check"]:
            worst = max(worst, row["max_abs_err"])
    if not worst <= SUM_TOL:
        raise AssertionError(f"phase 23: fused_update_e vs plain {worst}")
    return worst


def phase_submesh(device, out_dir, frames=SUB_FRAMES, scene=STEREO,
                  zoo_n=SUB_ZOO, max_rounds=STEREO_ROUNDS,
                  skew_fast=SUB_SKEW_FAST, skew_hold=SKEW_HOLD_S,
                  size=SUB_RANKS, meshes=SUB_MESHES,
                  timeout_s=SUB_TIMEOUT_S):
    """Phase 23: serving over sub-meshes. ``size`` gloo ranks in spawned
    processes sharing ``device``, split into ``meshes``; the stream is
    phase 14's cut to ``frames`` stereo frames and ``zoo_stream(zoo_n)``,
    at phase 14's config on ``"sharded"`` (``fused_update_e`` on each
    rank's slice). Rank 0 first runs the stream on one device through
    ``"triton"`` as the yardstick, as phase 17 (c) does. (a)
    ``serve_async`` on the first sub-mesh under ``windowed`` admission on
    the wall clock with two ingest threads: both ranks yield the same
    records, every one bitwise the yardstick's, two decision broadcasts a
    cycle and one at the end. (b) ``serve_routed`` over the sub-meshes:
    round robin without stealing, stereo frames on every replica, every
    record bitwise the yardstick's and each share bitwise its sub-mesh's
    solo ``serve_async``; then
    ``least_loaded`` with stealing on phase 15's skewed stream, at least
    one steal, every result bitwise a one-device ``"triton"`` run rank 0
    makes beside the yardstick (the skewed stream with ``skew_fast`` fast
    grids, ``SUB_SKEW_FAST``). ``fused_update_e`` against its plain
    version on one captured slice of each shape every rank served. Reports
    requests/s, latency p50/p99, steals, collectives, staged bytes,
    decision broadcasts per cycle and their host ms, each rank's peak
    memory in each run, the records a remote leader sent to the front
    with their cost, and the kernel's launches."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    cuda = device.type == "cuda"
    out_dir = Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    job = dict(meshes=meshes, scene=scene, frames=frames, zoo_n=zoo_n,
               max_rounds=max_rounds, skew_fast=skew_fast,
               skew_hold=skew_hold)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_submesh_rank, args=(size, str(out_dir),
                                                  device.type, job),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"phase 23's world did not finish in "
                                 f"{timeout_s} s")
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(size)]
    shutil.rmtree(out_dir, ignore_errors=True)
    n, n_skew = frames + zoo_n, skew_fast + 2
    worst = check_submesh(ranks, meshes, n, n_skew,
                          stereo_rids(frames, zoo_n), cuda)

    def numbers(r, name):
        return dict({k: v for k, v in r[name].items() if k != "rows"},
                    leader=r["leader"])
    worst_by_shape = {}
    for r in ranks:
        for row in r["kernel_check"]:
            key = (row["E"], row["S"])
            worst_by_shape[key] = max(worst_by_shape.get(key, 0.0),
                                      row["max_abs_err"])
    out = dict(ranks=size, meshes=[list(m) for m in meshes], requests=n,
               transport=ranks[0]["transport"], wall_s=wall,
               yardstick_s=ranks[0]["yardstick_s"],
               setup_s=[r["setup_s"] for r in ranks],
               seconds=[r["seconds"] for r in ranks],
               a={i: numbers(ranks[i], "a") for i in meshes[0]},
               rr={i: numbers(r, "rr") for i, r in enumerate(ranks)},
               solo={i: numbers(r, "solo") for i, r in enumerate(ranks)},
               ll={i: numbers(r, "ll") for i, r in enumerate(ranks)},
               kernel_check=[dict(E=e, S=s_, max_abs_err=err) for (e, s_), err
                             in sorted(worst_by_shape.items())],
               max_abs_err=worst)
    out["launches"] = {k: sum(
        r[name][field] for r in ranks
        for name in ("a", "rr", "solo", "ll") if name in r)
        for k, field in (("fused_update_e/sum", "launches"),
                         ("edge_prelude", "prelude_launches"))}
    return out


def log_submesh(out) -> None:
    """Phase 23's progress lines."""
    def row(label, r):
        lat = r.get("latency_ms", {"p50": float("nan"),
                                   "p99": float("nan")})
        return (f"{label}: {r['requests_per_s']:.2f} requests/s over "
                f"{r['wall_s']:.2f} s, latency p50/p99 {lat['p50']:.0f}/"
                f"{lat['p99']:.0f} ms, {r['cycles']} cycles at "
                f"{r['ms_per_cycle']:.1f} ms, {r['collectives']} "
                f"collectives, staged {r['staged_bytes']} B, decisions "
                f"{r['decisions']} ({r['decisions_per_cycle']:.2f} a cycle "
                f"and the last, {r['decision_bytes']} B, "
                f"{r['decision_ms'] / max(r['decisions'], 1):.3f} ms each "
                + ("published" if r["leader"] else "waited for") + "), "
                f"fused_update_e launches {r['launches']}, peak memory "
                f"{r['peak_memory_bytes']} B" + sent(r["sent_to_front"]))

    def sent(s):
        return (f", {s['records']} records sent to the front ("
                f"{s['tensor_bytes']} B of tensors, {s['ms']:.1f} ms to "
                "copy, pickle and send)" if s["records"] else "")
    log(f"  {out['ranks']} gloo ranks sharing the card, sub-meshes "
        f"{out['meshes']}, transport {out['transport']}, {out['requests']} "
        f"requests; {out['wall_s']:.1f} s with the spawn (set-up "
        f"{max(out['setup_s']):.1f} s, rank 0's one-device yardsticks "
        f"{out['yardstick_s']:.1f} s)")
    for i, r in out["a"].items():
        log("  (a) rank " + row(str(i), r))
    for name, label in (("rr", "(b) round robin"), ("solo", "(b) solo "
                                                    "share"),
                        ("ll", "(b) least_loaded, stealing")):
        for i, r in out[name].items():
            extra = (f"; routed {r['routed']}, steals {r['steals']} "
                     f"({r['stolen']} requests)" if "routed" in r
                     and r["routed"] and sum(r["routed"]) else "")
            log(f"  {label}, rank " + row(str(i), r) + extra)
    for r in out["kernel_check"]:
        log(f"  fused_update_e vs plain on a served slice, worst of the "
            f"ranks: E={r['E']} S={r['S']} max_abs_err="
            f"{r['max_abs_err']:.3g}")
    log("  bitwise: (a) both ranks, (a) and round robin vs the one-device "
        "yardstick, each share vs its solo sharded serve_async, "
        "least_loaded vs the one-device skewed run")
    log(f"  kernel launches on the sub-mesh path: {out['launches']}")


ROUND_COST_ARCHS = ("qwen3_4b", "mamba2_130m")   # (c)'s dry-run cells
ROUND_COST_TRAIN = dict(b=1, s=2048)  # (b): phase 19 (c)'s Qwen3-4B step
PEAK_RATIO = 2.0      # (b): predicted peak within 2x of phase 19's, each way
CALL_REPEAT = 2000    # (d): calls timed a way


def check_peak(predicted: float, measured) -> float | None:
    """``predicted / measured`` (None when nothing was measured); raises
    unless it is within ``PEAK_RATIO`` either way."""
    if measured is None:
        return None
    ratio = predicted / measured
    if not 1 / PEAK_RATIO <= ratio <= PEAK_RATIO:
        raise AssertionError(f"predicted peak {predicted} B is not within "
                             f"{PEAK_RATIO}x of the measured {measured} B")
    return ratio


def round_parts_ms(parts) -> float:
    """Phase 12's measured ms of one batched round: the sum of its
    top-level parts (the indented ones are the torch prelude and its
    gathers, which the ``edge_prelude`` kernel replaces)."""
    return sum(v for k, v in parts.items() if not k.startswith(" "))


def train_count(arch: str, b: int, s: int, reduced: bool, path) -> None:
    """Phase 24 (b)'s count, run in a subprocess (``start_counts``): one
    train step of ``arch`` (``reduced()`` if asked) at B = ``b``, S = ``s``
    on one device, counted on fake tensors by ``launch.dryrun``'s count;
    its flops, bytes, model flops and predicted peak written to ``path``
    as JSON."""
    from repro_torch import configs as TC
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models.model import param_specs
    from repro_torch.roofline import model_flops
    t0 = time.perf_counter()
    cfg = TC.get(arch).reduced() if reduced else TC.get(arch)
    count = dryrun._count_lm(cfg, InputShape("lm_train", s, b, "train"),
                             None, "tp", 1)
    flops = count.counter.cost.flops
    mf = model_flops(param_specs(cfg), b * s, cfg=cfg)
    Path(path).write_text(json.dumps(dict(
        arch=cfg.name, b=b, s=s, flops=flops,
        bytes=count.counter.cost.bytes, model_flops=mf,
        useful_ratio=mf / flops,
        predicted_peak_bytes=count.counter.live.peak,
        argument_bytes=count.argument_bytes,
        count_s=time.perf_counter() - t0)))


def start_counts(out_dir, archs=ROUND_COST_ARCHS, train=ROUND_COST_TRAIN,
                 train_arch="qwen3_4b", reduced=False) -> dict:
    """Start phase 24's host counts in two subprocesses, which take no
    card and so run beside the earlier phases: (b) ``train_count`` and (c)
    ``python -m repro_torch.launch.dryrun`` over ``archs`` at
    ``decode_32k`` on the single-pod mesh. ``finish_counts`` collects
    them."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    code = (f"import sys; sys.path[:0] = [{str(SRC)!r}, {str(REPO)!r}]; "
            f"import chip_smoke as cs; cs.train_count({train_arch!r}, "
            f"{train['b']}, {train['s']}, {reduced}, "
            f"{str(out_dir / 'train_count.json')!r})")
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           ",".join(archs), "--shape", "decode_32k", "--mesh", "single",
           "--out", str(out_dir)]
    procs = {}
    for name, cmd in (("train", [sys.executable, "-c", code]),
                      ("dryrun", dry)):
        with open(out_dir / f"{name}.log", "w") as log_file:
            procs[name] = subprocess.Popen(cmd, cwd=REPO, env=env,
                                           stdout=log_file,
                                           stderr=subprocess.STDOUT)
    return dict(procs, out_dir=out_dir, archs=tuple(archs),
                t0=time.perf_counter())


def finish_counts(started, timeout_s=300):
    """Wait for ``start_counts``' subprocesses; raise if either failed or a
    dry-run cell is not ``ok``. Returns ``(train, dryrun)``: the train
    step's count and ``{"cells": {arch: fields}, "s": seconds}``."""
    out_dir = started["out_dir"]
    for name in ("train", "dryrun"):
        proc = started[name]
        try:
            proc.wait(timeout=timeout_s)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            text = (out_dir / f"{name}.log").read_text()
            raise AssertionError(f"{name} count exited {proc.returncode}:\n"
                                 f"{text[-4000:]}")
    wall = time.perf_counter() - started["t0"]
    train = json.loads((out_dir / "train_count.json").read_text())
    cells = {}
    for arch in started["archs"]:
        rec = json.loads((out_dir / f"{arch}__decode_32k__16x16.json")
                         .read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun cell {arch}: {rec.get('error')}")
        cells[arch] = {k: rec[k] for k in (
            "flops", "hbm_bytes", "coll_bytes", "bottleneck",
            "useful_ratio", "memory_per_device", "param_bytes",
            "fake_device", "count_s")}
    return train, dict(cells=cells, s=wall)


def phase_round_cost(device, batch, round_ms, lm_peak, counts):
    """Phase 24, the cost counters (``roofline.op_cost``, ``kernel_model.
    round_cost``, ``launch.dryrun``):

    (a) one engine round (``kernel_model.engine_round``) of the stereo
    bucket's union on ``device`` counted by an ``OpCounter`` under
    ``"triton"``, ``"pallas"`` and ``"triton"`` at ``semiring="max"``
    (RnBP as phase 10): each update kernel launched through its dispatcher
    op held against its plain version on the same operands (sum within
    ``SUM_TOL``, max bitwise), its counted flops and bytes exactly
    ``fused_update_cost``'s; the edge prelude's op bitwise
    ``messages.edge_prelude`` and counted exactly ``edge_prelude_cost``;
    the round's counted bytes over ``round_ms``
    (phase 12's ms a round) as a share of the card's memory rate; the
    launches of the three rounds are the ``round_cost`` path's;
    (b) Qwen3-4B as published trained one step at ``ROUND_COST_TRAIN``,
    counted on fake tensors: its flops beside ``model_flops`` and its
    predicted peak beside ``lm_peak`` (phase 19 (c)'s
    ``max_memory_allocated``), within ``PEAK_RATIO`` either way;
    (c) ``python -m repro_torch.launch.dryrun`` over
    ``ROUND_COST_ARCHS`` at ``decode_32k`` on the single-pod mesh: every
    cell ``ok``;
    (d) the host's cost of a call through the dispatcher op against the
    kernel's launch called directly, at E = 1,024, S = 2 (``CALL_REPEAT``
    calls each).

    (b) and (c) run on the host in subprocesses that ``counts``
    (``start_counts``) started before the earlier phases."""
    import torch
    from repro_torch.core import messages as M
    from repro_torch.core.schedulers import RnBP
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.kernels.ops import make_pallas_update, make_triton_update
    from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
    from repro_torch.roofline.kernel_model import (card_peaks,
                                                   edge_prelude_cost,
                                                   engine_round,
                                                   fused_update_cost)
    from repro_torch.roofline.op_cost import OpCounter, charge

    class Captured(OpCounter):
        """An ``OpCounter`` that keeps each kernel op's operands, results
        and counted cost."""

        def __init__(self):
            super().__init__()
            self.kernel_calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.namespace == "repro_torch":
                self.kernel_calls.append((func.overloadpacket.__name__,
                                          args, out, charge(
                                              func, args, kwargs, out)))
            return out

    out = dict(rounds={})
    union = batch.folded()
    e, s = union.n_edges, union.n_states_max
    bw = card_peaks(torch.cuda.get_device_name(0))[0] \
        if device.type == "cuda" else 3.35e12
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    for label, update, semiring in (
            ("triton", make_triton_update(), "sum"),
            ("pallas", make_pallas_update(), "sum"),
            ("map", make_triton_update(semiring="max"), "max")):
        one_round, args = engine_round(
            union, RnBP(**MAIN_KW), update, eps=1e-3,
            rng=torch.Generator(device=device).manual_seed(0))
        with Captured() as c:
            one_round(*args)
        sync(device)
        (_, p_ops, p_got, p_cost), (name, ops, got, cost) = c.kernel_calls
        if not torch.equal(p_got, M.edge_prelude(union, p_ops[0])):
            raise AssertionError(f"{label}: the edge prelude's op is not "
                                 "bitwise messages.edge_prelude")
        p_model = edge_prelude_cost(e, union.n_vertices, s,
                                    union.in_edges.shape[1])
        if p_cost != {"fused": p_model}:
            raise AssertionError(f"{label}: the edge prelude's op counted "
                                 f"{p_cost}, not edge_prelude_cost's "
                                 f"{p_model}")
        plain = (fused_update_e_ref(*ops) if name == "fused_update_e"
                 else fused_update_t_ref(*ops))
        err = compare(semiring, got, plain)
        model = fused_update_cost(e, s, semiring=semiring)
        fused = cost["fused"]
        if (fused.flops, fused.bytes) != (model.flops, model.bytes):
            raise AssertionError(f"{label}: the kernel op counted {fused}, "
                                 f"not fused_update_cost's {model}")
        cost = c.cost
        out["rounds"][label] = dict(
            kernel=name, semiring=semiring, E=e, S=s, max_abs_err=err,
            flops=cost.flops, bytes=cost.bytes,
            by_class={k: [v.flops, v.bytes] for k, v in c.by_class.items()},
            kernel_bytes=fused.bytes, kernel_flops=fused.flops,
            bytes_share_of_round=fused.bytes / cost.bytes,
            round_ms=round_ms,
            memory_share=cost.bytes / (round_ms / 1e3) / bw
            if round_ms else None)
        del args, ops, got, plain, p_ops, p_got
    out["launches"] = {"fused_update_e/sum": TT.LAUNCHES["sum"],
                       "fused_update_e/max": TT.LAUNCHES["max"],
                       "fused_update_t/sum": MU.LAUNCHES["sum"],
                       "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    if 0 in out["launches"].values():
        raise AssertionError(f"a kernel of the round_cost path was not "
                             f"launched: {out['launches']}")

    # (d) the dispatcher's cost a call, against the launch called directly
    g = torch.Generator(device=device).manual_seed(0)
    ops = random_operands(1024, 2, g, device)

    def loop(fn):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(CALL_REPEAT):
            fn()
        sync(device)
        return (time.perf_counter() - t0) / CALL_REPEAT * 1e6

    def direct():
        TT._check(*ops, "sum")
        return TT._launch(*ops) if device.type == "cuda" \
            else fused_update_e_ref(*ops)
    us = {}
    for way, fn in (("op", lambda: TT.fused_update_e(*ops)),
                    ("direct", direct), ("direct ", direct),
                    ("op ", lambda: TT.fused_update_e(*ops))):
        us.setdefault(way.strip(), []).append(loop(fn))
    out["call_us"] = {k: sum(v) / len(v) for k, v in us.items()}
    out["call_us"]["E"], out["call_us"]["S"] = 1024, 2

    # (b) and (c), counted on the host beside the earlier phases
    train, out["dryrun"] = finish_counts(counts)
    peak = train["predicted_peak_bytes"]
    out["train"] = dict(train, measured_peak_bytes=lm_peak,
                        peak_ratio=check_peak(peak, lm_peak))
    return out


def log_round_cost(out) -> None:
    """Phase 24's progress lines."""
    for label, r in out["rounds"].items():
        share = "" if r["memory_share"] is None else \
            f", {r['bytes'] / 1e6:.3f} MB over phase 12's " \
            f"{r['round_ms']:.3f} ms a round = {r['memory_share']:.4f} of " \
            "the card's memory rate"
        log(f"  round_cost {label}: E={r['E']} S={r['S']} "
            f"{r['flops']:.4g} flops, {r['bytes']:.4g} B; the kernel "
            f"({r['kernel']}/{r['semiring']}, its dispatcher op) "
            f"{r['kernel_bytes']:.4g} B = fused_update_cost's, "
            f"{r['bytes_share_of_round']:.3f} of the round's bytes; vs "
            f"plain max_abs_err={r['max_abs_err']:.3g}{share}")
    t = out["train"]
    ratio = "" if t["peak_ratio"] is None else \
        f" (phase 19: {t['measured_peak_bytes'] / 1e9:.2f} GB, ratio " \
        f"{t['peak_ratio']:.3f})"
    log(f"  {t['arch']} train step B={t['b']} S={t['s']} on fake tensors: "
        f"{t['flops']:.4g} flops, model_flops {t['model_flops']:.4g}, "
        f"useful {t['useful_ratio']:.3f}; predicted peak "
        f"{t['predicted_peak_bytes'] / 1e9:.2f} GB{ratio}; counted in "
        f"{t['count_s']:.1f} s")
    for arch, c in out["dryrun"]["cells"].items():
        mem = c["memory_per_device"]
        log(f"  dryrun {arch} decode_32k 16x16: ok, flops/dev "
            f"{c['flops']:.4g}, bytes/dev {c['hbm_bytes']:.4g}, coll/dev "
            f"{c['coll_bytes']:.4g}, bottleneck {c['bottleneck']}, useful "
            f"{c['useful_ratio']:.3f}, peak {mem['peak_bytes'] / 1e9:.3f} "
            f"GB, fits 80 GB {mem['peak_ok_80GB']}")
    log(f"  the host's counts (b), (c): {out['dryrun']['s']:.1f} s in "
        "subprocesses, from their start")
    cu = out["call_us"]
    log(f"  a call at E={cu['E']} S={cu['S']}: {cu['op']:.2f} us through "
        f"the dispatcher op, {cu['direct']:.2f} us to the launch directly")
    log(f"  kernel launches on the round_cost path: {out['launches']}")


# ------------------------------------------------------------- phase 25 --

def _drive(module, argv, device):
    """``module.main(argv)`` as a user calls it (on the card by default;
    ``--device cpu`` added off the card), stdout captured: (its return,
    its stdout, the kernels' launches during the call, wall seconds)."""
    import contextlib
    import io
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    if device.type != "cuda":
        argv = argv + ["--device", device.type]
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = module.main(argv)
    sync(device)
    wall = time.perf_counter() - t0
    launches = {"fused_update_e/sum": TT.LAUNCHES["sum"],
                "fused_update_e/max": TT.LAUNCHES["max"],
                "fused_update_t/sum": MU.LAUNCHES["sum"],
                "edge_prelude": EP.LAUNCHES["edge_prelude"]}
    return out, buf.getvalue(), launches, wall


def phase_entry_points(device, argv=None):
    """Phase 25: the drivers of ``repro_torch.examples`` through their
    ``main`` (``argv``: driver -> arguments, ``ENTRY_ARGV``), each counted
    from 0 just before its call, with the reference's acceptances: (a)
    quickstart: LBP stalls at its cap, RBP and both RnBP runs converge,
    ``fused_update_e`` sum launched at least once a round; (b) stereo_bp:
    accuracy at least the observation's, energy at most the truth's, the
    labels and rounds bitwise the plain ``"maxprod"`` path's on the same
    device (a comparison run, not counted), max launched once a round;
    (c) ldpc_decode: coded BER below uncoded at two SNR points or more,
    max launched once a round; (d) bp_serving, async and routed: every
    request converged, requests/s and latency percentiles; (e) train_lm:
    resume drift exactly 0. ``distributed_bp`` runs in phase 17's world
    (``_gloo_entry``)."""
    from repro_torch.examples import (bp_serving, ldpc_decode, quickstart,
                                      stereo_bp, train_lm)
    argv = argv or ENTRY_ARGV
    cuda = device.type == "cuda"
    out = {}

    def launched(name, kernel, rounds, launches):
        if cuda and launches[kernel] < rounds:
            raise AssertionError(f"{name}: {launches[kernel]} {kernel} "
                                 f"launches < {rounds} rounds")

    q, text, launches, wall = _drive(quickstart, argv["quickstart"], device)
    rows = q["rows"]
    if rows[0]["converged"] or not all(r["converged"] for r in rows[1:]) \
            or not q["rnbp"]["converged"]:
        raise AssertionError("quickstart: LBP must stall and the others "
                             f"converge: {rows}")
    rounds = sum(r["rounds"] for r in rows) + q["rnbp"]["rounds"]
    launched("quickstart", "fused_update_e/sum", rounds, launches)
    out["quickstart"] = dict(rows=rows, rounds=rounds, launches=launches,
                             wall_s=wall, stdout=text,
                             marginals=q["marginals"][:5].tolist())

    st, text, launches, wall = _drive(stereo_bp, argv["stereo_bp"], device)
    args = stereo_bp.parser().parse_args(
        argv["stereo_bp"] + ([] if cuda else ["--device", device.type]))
    plain = stereo_bp.run(args, backend="maxprod")
    bitwise = bool((plain["labels"] == st["labels"]).all()) and \
        plain["rounds"] == st["rounds"]
    acc, en = st["accuracy"], st["energy"]
    if not (bitwise and acc["bp"] >= acc["observation"]
            and en["bp"] <= en["truth"]):
        raise AssertionError(f"stereo_bp: bitwise plain {bitwise}, "
                             f"accuracy {acc}, energy {en}")
    launched("stereo_bp", "fused_update_e/max", st["rounds"], launches)
    out["stereo_bp"] = dict(converged=st["converged"], rounds=st["rounds"],
                            accuracy=acc, energy=en, bitwise_plain=bitwise,
                            plain_wall_s=plain["wall_s"], launches=launches,
                            wall_s=wall, run_s=st["wall_s"])

    ld, text, launches, wall = _drive(ldpc_decode, argv["ldpc_decode"],
                                      device)
    better = sum(r["coded_ber"] < r["uncoded_ber"] for r in ld["rows"])
    if better < 2:
        raise AssertionError(f"ldpc_decode: coded BER below uncoded at "
                             f"{better} SNR points: {ld['rows']}")
    launched("ldpc_decode", "fused_update_e/max",
             sum(sum(r["rounds"]) for r in ld["rows"]), launches)
    out["ldpc_decode"] = dict(rows=ld["rows"], launches=launches,
                              wall_s=wall, stdout=text)

    for key in ("bp_serving/async", "bp_serving/routed"):
        sv, text, launches, wall = _drive(bp_serving, argv[key], device)
        n = len(sv["requests"])
        if sv["converged"] != n or n == 0:
            raise AssertionError(f"{key}: {sv['converged']}/{n} converged")
        launched(key, "fused_update_e/sum", 1, launches)
        out[key] = dict({k: v for k, v in sv.items() if k != "requests"},
                        requests=n, launches=launches, wall_s=wall,
                        summary=text.split("\nserved ", 1)[1].strip())

    tr, text, launches, wall = _drive(train_lm, argv["train_lm"], device)
    if tr["drift"] != 0.0:
        raise AssertionError(f"train_lm: resume drift {tr['drift']}")
    out["train_lm"] = dict(n_params=tr["n_params"], drift=tr["drift"],
                           first_loss=tr["losses"][0],
                           last_loss=tr["losses"][-1], launches=launches,
                           wall_s=wall, stdout=text)
    out["launches"] = {k: sum(v["launches"][k] for v in out.values())
                       for k in ("fused_update_e/sum", "fused_update_e/max",
                                 "fused_update_t/sum", "edge_prelude")}
    return out


def log_entry_points(out) -> None:
    """Phase 25's progress lines (``out["distributed_bp"]``: phase 17's
    ``entry``)."""
    q = out["quickstart"]
    for r in q["rows"]:
        log(f"  quickstart {r['name'].strip()}: converged={r['converged']} "
            f"rounds={r['rounds']} updates={r['updates']} "
            f"wall={r['wall_s']:.3f} s")
    log(f"  quickstart: fused_update_e/sum launches "
        f"{q['launches']['fused_update_e/sum']} over {q['rounds']} rounds; "
        f"first marginals {q['marginals']}")
    st = out["stereo_bp"]
    log(f"  stereo_bp {ENTRY_ARGV['stereo_bp']}: converged={st['converged']}"
        f" rounds={st['rounds']} accuracy {st['accuracy']} energy "
        f"{st['energy']}; labels bitwise the plain maxprod path "
        f"({st['plain_wall_s']:.2f} s); fused_update_e/max launches "
        f"{st['launches']['fused_update_e/max']}")
    ld = out["ldpc_decode"]
    for r in ld["rows"]:
        log(f"  ldpc_decode snr {r['snr_db']}: uncoded {r['uncoded_ber']:.4f}"
            f" coded {r['coded_ber']:.4f} converged {r['converged']} mean "
            f"rounds {sum(r['rounds']) / len(r['rounds']):.1f}")
    log(f"  ldpc_decode: fused_update_e/max launches "
        f"{ld['launches']['fused_update_e/max']}")
    for key in ("bp_serving/async", "bp_serving/routed"):
        sv = out[key]
        log(f"  {key} ({sv['backend']}): {sv['converged']}/{sv['requests']}"
            f" converged, {sv['requests_per_s']:.2f} requests/s, latency ms "
            f"p50={sv['latency_ms']['p50']:.1f} "
            f"p99={sv['latency_ms']['p99']:.1f}; stats {sv['stats']}; "
            f"launches {sv['launches']}")
    tr = out["train_lm"]
    log(f"  train_lm {ENTRY_ARGV['train_lm']}: {tr['n_params']} params, "
        f"loss {tr['first_loss']:.4f} -> {tr['last_loss']:.4f}, resume "
        f"drift {tr['drift']:.2e}")
    d = out["distributed_bp"]
    log(f"  distributed_bp --size {ENTRY_DIST_SIZE} (phase 17's gloo "
        f"ranks): sharded rounds {d['rounds']} bitwise the one-device runs,"
        f" banded LBP {d['banded_rounds']} rounds, parity True; "
        f"fused_update_e/sum launches per rank {d['launches']}")
    for line in d["stdout"].splitlines():
        log(f"    {line}")
    for key in ("quickstart", "stereo_bp", "ldpc_decode", "bp_serving/async",
                "bp_serving/routed", "train_lm", "distributed_bp"):
        log(f"  {key} wall {out[key]['wall_s']:.2f} s")


# ------------------------------------------------------------- phase 26 --

def doc_blocks(path):
    """The ``python`` code blocks of a markdown file, in order."""
    import re
    return re.findall(r"```python\n(.*?)```", Path(path).read_text(),
                      flags=re.DOTALL)


def readme_port_block():
    """README's first ``repro_torch`` code block: the one-graph main path,
    the batched one, ``serve_async`` and ``serve_routed`` at full size."""
    return next(b for b in doc_blocks(REPO / "README.md")
                if "repro_torch" in b)


@contextlib.contextmanager
def registries_restored():
    """The port's registries as they were before, after the block: a page
    registers its demo entries (schedulers, backends, batched backends,
    admission and routing policies, workloads) into them."""
    from repro_torch.core.schedulers import SCHEDULERS
    from repro_torch.core.serving import ADMISSION_POLICIES
    from repro_torch.kernels.ops import BATCH_UPDATE_BACKENDS, UPDATE_BACKENDS
    from repro_torch.pgm.datasets import WORKLOADS
    from repro_torch.serve.routing import ROUTING_POLICIES
    registries = (SCHEDULERS, UPDATE_BACKENDS, BATCH_UPDATE_BACKENDS,
                  ADMISSION_POLICIES, ROUTING_POLICIES, WORKLOADS)
    snapshots = [dict(r) for r in registries]
    try:
        yield
    finally:
        for reg, snap in zip(registries, snapshots):
            reg.clear()
            reg.update(snap)


def run_blocks(name, blocks, ns, device):
    """Each block of ``blocks`` in ``ns``, in order, its stdout captured,
    counted from 0 just before: (stdout, the kernels' launches, seconds
    per block to the card's last kernel). A failing block raises."""
    import io
    from repro_torch.kernels import edge_prelude as EP
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    TT.reset_launch_counts()
    MU.reset_launch_counts()
    EP.reset_launch_counts()
    buf = io.StringIO()
    seconds = []
    with registries_restored(), contextlib.redirect_stdout(buf):
        for i, block in enumerate(blocks):
            t0 = time.perf_counter()
            exec(compile(block, f"{name}[block {i}]", "exec"), ns)
            sync(device)
            seconds.append(time.perf_counter() - t0)
    return buf.getvalue(), {"fused_update_e/sum": TT.LAUNCHES["sum"],
                            "fused_update_e/max": TT.LAUNCHES["max"],
                            "fused_update_t/sum": MU.LAUNCHES["sum"],
                            "edge_prelude": EP.LAUNCHES["edge_prelude"]}, \
        seconds


def phase_docs(device, pages=DOCS_PAGES, readme=None):
    """Phase 26: every page of ``docs/torch/`` run as a reader runs it,
    its blocks in order in one namespace with ``DEVICE`` set to the card
    (``sharding.md``'s first block makes an NCCL world of one, as phase 17
    (a)'s, and its last destroys it), each page counted from 0; then
    README's first port block (``readme``: its text, by default
    ``readme_port_block()``) at its full size: RnBP on Ising 1000 x 1000
    through ``"triton"``, four Tsukuba-size frames through ``"pallas"`` in
    ``run_many``, ``serve_async`` and ``serve_routed``. Checks: every
    block's own asserts; ``kernels.md``'s kernel against its plain version
    (sum within ``SUM_TOL``, max bitwise); README's runs converged, every
    request served and its beliefs finite; on the card, each kernel
    launched at least once over the pages and README."""
    import torch
    out = {"pages": {}}
    for page in pages:
        blocks = doc_blocks(REPO / "docs" / "torch" / page)
        ns = {"DEVICE": device.type}
        text, launches, secs = run_blocks(f"docs/torch/{page}", blocks, ns,
                                          device)
        out["pages"][page] = dict(blocks=len(blocks), seconds=sum(secs),
                                  block_s=secs, launches=launches,
                                  stdout=text)
        if page == "kernels.md":
            err = ns["err"]
            if err["sum"] > SUM_TOL or err["max"] != 0.0:
                raise AssertionError(f"kernels.md: fused_update_e against "
                                     f"its plain version: {err}")
            out["kernel_check"] = {"fused_update_e/sum": err["sum"],
                                   "fused_update_e/max": err["max"]}
    ns = {}
    text, launches, secs = run_blocks("README.md", [readme or
                                                    readme_port_block()],
                                      ns, device)
    res, results, rep, routed = (ns["res"], ns["results"], ns["rep"],
                                 ns["routed"])
    frames = ns["frames"]
    if not (bool(res.converged) and all(bool(r.converged) for r in results)
            and len(rep.records) == len(routed.records) == len(frames)
            and all(r.status == "completed" for r in routed.records)):
        raise AssertionError("README: a run did not converge or a request "
                             "was not served")
    for pgm, r in [(ns["pgm"], res)] + list(zip(frames, results)) + [
            (frames[rec.rid], rec.result)
            for rec in list(rep.records) + list(routed.records)]:
        b = r.beliefs
        if not (bool(torch.isfinite(b).all()) and b.dim() == 2
                and b.shape[0] >= pgm.n_real_vertices):
            raise AssertionError(f"README: beliefs {tuple(b.shape)} not "
                                 "finite or misshapen")
    out["readme"] = dict(
        seconds=secs[0], launches=launches, stdout=text,
        rounds=int(res.rounds), run_many_rounds=[int(r.rounds)
                                                 for r in results],
        wasted_sweeps=rep.stats.wasted_sweeps,
        routed=list(routed.stats.routed))
    out["launches"] = {k: sum(p["launches"][k] for p in
                              list(out["pages"].values()) + [out["readme"]])
                       for k in launches}
    if device.type == "cuda":
        idle = [k for k, n in out["launches"].items() if n == 0]
        if idle:
            raise AssertionError(f"phase 26 launched no {idle}")
    return out


def docs_line(out) -> dict:
    """The ``{"docs": ...}`` line: blocks run, seconds per page (README's
    block as ``README.md``), launches per kernel."""
    seconds = {p: v["seconds"] for p, v in out["pages"].items()}
    seconds["README.md"] = out["readme"]["seconds"]
    return dict(blocks=sum(v["blocks"] for v in out["pages"].values()) + 1,
                seconds=seconds, launches=out["launches"],
                phase_s=out.get("phase_s"))


def log_docs(out) -> None:
    """Phase 26's progress lines."""
    for page, v in out["pages"].items():
        log(f"  docs/torch/{page}: {v['blocks']} blocks in "
            f"{v['seconds']:.2f} s (" + ", ".join(f"{t:.2f}"
                                                 for t in v["block_s"])
            + f"); launches {v['launches']}")
    log(f"  kernels.md: fused_update_e vs plain {out['kernel_check']}")
    r = out["readme"]
    log(f"  README's first port block: RnBP 1000^2 {r['rounds']} rounds; "
        f"run_many rounds {r['run_many_rounds']}; serve_async wasted "
        f"sweeps {r['wasted_sweeps']}; serve_routed {r['routed']}; "
        f"{r['seconds']:.2f} s; launches {r['launches']}")
    for line in r["stdout"].splitlines():
        log(f"    {line}")
    log(f"  launches over the pages and README: {out['launches']}")


def launches_by_path(main, mapd, bmain, serving, routed, resilient,
                     dist_one, lm, lm_train, lm_shard, lm_strain, lm_blocks,
                     submesh, round_cost, entry=None, docs=None):
    """Each kernel's launches on each path, as the phases counted them:
    the one-graph path (phase 4; max-product: the MAP path of phase 5),
    the batched path (phase 10), the serving path (phase 14), the routed
    path (phase 15: run (a), the deadline run, the skewed runs; each
    counted from 0), the resilient run (phase 16), the multi-device
    paths of phase 17 (a): ``sharded`` and ``banded``, the LM stack's
    serving path (phase 18, ``lm``), its training path (phase 19,
    ``lm_train``), its sharded serving path (phase 20, ``lm_sharded``: the
    parent's launches; its spawned ranks run no BP kernel either), its
    sharded training path (phase 21, ``lm_sharded_train``, the same) and
    its tensor-parallel block families (phase 22, ``lm_blocks``, the
    same), serving over sub-meshes (phase 23, ``sub_meshes``: the four
    ranks' launches in all of its runs, summed), and the counted rounds of
    phase 24 (a) (``round_cost``), and the entry points of phase 25
    (``entry_points``: its drivers' launches in this process plus
    ``distributed_bp``'s on every rank of phase 17's world), and the docs'
    pages and README's first port block of phase 26 (``docs``)."""
    srv, rt, lm = serving["launches"], routed["launches"], lm["launches"]
    ep = dict((entry or {}).get("launches", {}))
    ep["fused_update_e/sum"] = ep.get("fused_update_e/sum", 0) + sum(
        (entry or {}).get("distributed_bp", {}).get("launches", ()))
    lmt, lms = lm_train["launches"], lm_shard["launches"]
    lmst, lmb = lm_strain["launches"], lm_blocks["launches"]
    sub, rc = submesh["launches"], round_cost["launches"]
    dl = (docs or {}).get("launches", {})
    return {
        "fused_update_e/sum": dict(one_graph=main["launches"]["sum"],
                                   batched=bmain["other_launches"]["sum"],
                                   serving=srv["fused_update_e/sum"],
                                   routed=rt.get("fused_update_e/sum", 0),
                                   resilient=resilient["launches"]["sum"],
                                   sharded=dist_one["sharded"]["launches"],
                                   banded=dist_one["banded"]["launches"],
                                   lm=lm["fused_update_e/sum"],
                                   lm_train=lmt["fused_update_e/sum"],
                                   lm_sharded=lms["fused_update_e/sum"],
                                   lm_sharded_train=lmst["fused_update_e/sum"],
                                   lm_blocks=lmb["fused_update_e/sum"],
                                   sub_meshes=sub["fused_update_e/sum"],
                                   round_cost=rc["fused_update_e/sum"],
                                   entry_points=ep["fused_update_e/sum"],
                                   docs=dl.get("fused_update_e/sum", 0)),
        "fused_update_e/max": dict(one_graph=mapd["launches"],
                                   batched=bmain["other_launches"]["max"],
                                   serving=srv["fused_update_e/max"],
                                   routed=rt.get("fused_update_e/max", 0),
                                   resilient=resilient["launches"]["max"],
                                   sharded=0, banded=0,
                                   lm=lm["fused_update_e/max"],
                                   lm_train=lmt["fused_update_e/max"],
                                   lm_sharded=lms["fused_update_e/max"],
                                   lm_sharded_train=lmst["fused_update_e/max"],
                                   lm_blocks=lmb["fused_update_e/max"],
                                   sub_meshes=0,
                                   round_cost=rc["fused_update_e/max"],
                                   entry_points=ep.get("fused_update_e/max",
                                                       0),
                                   docs=dl.get("fused_update_e/max", 0)),
        "fused_update_t/sum": dict(one_graph=main["launches"]["t"],
                                   batched=bmain["launches"],
                                   serving=srv["fused_update_t/sum"],
                                   routed=rt.get("fused_update_t/sum", 0),
                                   resilient=0, sharded=0, banded=0,
                                   lm=lm["fused_update_t/sum"],
                                   lm_train=lmt["fused_update_t/sum"],
                                   lm_sharded=lms["fused_update_t/sum"],
                                   lm_sharded_train=lmst["fused_update_t/sum"],
                                   lm_blocks=lmb["fused_update_t/sum"],
                                   sub_meshes=0,
                                   round_cost=rc["fused_update_t/sum"],
                                   entry_points=ep.get("fused_update_t/sum",
                                                       0),
                                   docs=dl.get("fused_update_t/sum", 0))}


#: the paths on which every update runs through a kernel backend
#: (``"triton"``, ``"pallas"`` or their bucket folds), so the edge-prelude
#: kernel launches once for each update kernel's launch. The sharded and
#: banded paths, the sub-meshes and ``distributed_bp`` run ``dist``'s own
#: prelude, and ``kernels.md`` launches ``fused_update_e`` on operands of
#: its own: there the prelude launches fewer times or not at all.
PRELUDE_PATHS = ("one_graph", "batched", "serving", "routed", "resilient",
                 "lm", "lm_train", "lm_sharded", "lm_sharded_train",
                 "lm_blocks", "round_cost")
UPDATE_KERNELS = ("fused_update_e/sum", "fused_update_e/max",
                  "fused_update_t/sum")


def prelude_by_path(main, mapd, bmain, serving, routed, resilient,
                    dist_one, lm, lm_train, lm_shard, lm_strain, lm_blocks,
                    submesh, round_cost, entry, docs):
    """The edge-prelude kernel's launches on each path of
    ``launches_by_path``, as the same phases counted them, each from 0
    just before its path ran (the one-graph path: phase 4's RnBP and
    phase 5's MAP run; ``entry_points``: the drivers in this process;
    ``distributed_bp``'s ranks run ``dist``'s prelude)."""
    def kernel(report):
        return report["launches"]["edge_prelude"]
    return dict(one_graph=main["launches"]["prelude"]
                + mapd["prelude_launches"],
                batched=bmain["prelude_launches"], serving=kernel(serving),
                routed=kernel(routed),
                resilient=resilient["launches"]["prelude"],
                sharded=dist_one["sharded"]["prelude_launches"],
                banded=dist_one["banded"]["prelude_launches"],
                lm=kernel(lm), lm_train=kernel(lm_train),
                lm_sharded=kernel(lm_shard),
                lm_sharded_train=kernel(lm_strain),
                lm_blocks=kernel(lm_blocks), sub_meshes=kernel(submesh),
                round_cost=kernel(round_cost), entry_points=kernel(entry),
                docs=kernel(docs))


def check_prelude_launches(by_path) -> None:
    """Raise unless, on each of ``PRELUDE_PATHS``, the edge-prelude kernel
    (``by_path["edge_prelude"]``) launched as many times as the update
    kernels together: one prelude before every fused update."""
    for path in PRELUDE_PATHS:
        updates = sum(by_path[k][path] for k in UPDATE_KERNELS)
        if by_path["edge_prelude"][path] != updates:
            raise AssertionError(
                f"{path}: {by_path['edge_prelude'][path]} edge-prelude "
                f"launches for {updates} fused updates")


def log_serving(out) -> None:
    """Phase 14's progress lines."""
    st, lat, tr = out["stats"], out["latency_ms"], out["traced"]
    log(f"  served {out['requests']} requests in {out['wall_s']:.3f} s = "
        f"{out['requests_per_s']:.2f} requests/s (no timer, no added "
        f"synchronization); peak memory "
        f"{out['peak_memory_bytes'] / 2**30:.2f} GiB")
    for field in ("latency", "admission", "service"):
        p = lat[field]
        log(f"  completed {field} ms: p50={p['p50']:.1f} p90={p['p90']:.1f} "
            f"p99={p['p99']:.1f}")
    log(f"  sweeps: device={st['device_sweeps']} useful={st['useful_sweeps']}"
        f" wasted={st['wasted_sweeps']}; chunks={st['chunks']} evacuated="
        f"{st['evacuated']} backfilled={st['backfilled']} compactions="
        f"{st['compactions']} buckets={st['buckets_opened']} widths="
        f"{st['admission_widths']}")
    log(f"  traced run: {tr['requests']} requests in {tr['wall_s']:.3f} s; "
        f"card busy {tr['busy_s']:.3f} s ({tr['device_events']} device "
        f"events) = idle share {tr['idle_share']:.3f}; busy / untraced wall "
        f"{tr['busy_over_untraced_wall']:.3f}; steps' device spans "
        f"{tr['step_device_s']:.3f} s; backfilled="
        f"{tr['stats']['backfilled']} chunks={tr['stats']['chunks']}")
    log("  traced run, host seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tr["host_seconds"].items()))
    for name, rows in out["kernel_check"].items():
        for r in rows:
            log(f"  {name} vs plain on a served chunk: B={r['B']} E={r['E']} "
                f"S={r['S']} rounds={r['rounds']} max_abs_err="
                f"{r['max_abs_err']:.3g}")
    b = out["backfill_ms"]
    log(f"  one backfill at the serving shape (B={b['B']} E={b['E']} "
        f"S={b['S']}): load_slot {b['load_slot']:.3f} ms + fold/transposed "
        f"table rebuild {b['fold_rebuild']:.3f} ms")
    for f in out["frames"]:
        log(f"  stereo rid {f['rid']}: rounds={f['rounds']} converged="
            f"{f['converged']} latency {f['latency_s'] * 1e3:.1f} ms")
    log(f"  bitwise equal to padded solo runs: {out['bitwise_solo']}; "
        f"engine.serve == run_many bitwise over 4 frames (rounds "
        f"{out['serve_equals_run_many']})")
    d = out["deadline"]
    log(f"  deadline/SweepClock LBP over the zoo: {d['requests']} requests, "
        f"{d['evictions']} evicted (mid-flight (rid, t_done, rounds): "
        f"{d['midflight']}); timeline and stats equal on card and CPU, "
        f"completed beliefs within {d['max_prob_diff']:.3g}")
    log(f"  kernel launches on the serving path: {out['launches']}")


def kernels_line(timing, btiming, worst, worst_t, launches, launches_t,
                 by_path, served=None, prelude=None):
    """The ``{"kernels": [...]}`` entries: per kernel its main path's
    launches, ``launches_by_path`` (``by_path[name]``: its launches on the
    one-graph, batched, serving, routed, resilient, sharded, banded, LM
    serving and LM training paths, each counted from 0 just before the path
    ran), its largest
    difference from the plain version over phases 3, 7, 9 and 12, the
    captured chunks of the serving and routed paths, the resilient run
    and the captured rank slices of phase 17 (``served``: name -> rows
    with ``max_abs_err``), the main path's shape's
    times and bound, and
    ``shapes``,
    one ``{E, S, ms, device_ms, bound_ms, plain_ms}`` per timed shape
    (``ms`` from CUDA events around back-to-back calls, ``device_ms`` the
    kernel's own time from the profiler; the one-graph
    S = 2 path, the protein MRF, the stereo bucket, the zoo's widest
    bucket). With ``prelude`` (``phase_prelude``'s rows) and
    ``launches["prelude"]`` (the one-graph path's), the edge-prelude
    kernel's entry follows: its largest difference from
    ``messages.edge_prelude`` (0: ``phase_prelude`` and phase 24 raise on
    any bit of difference), the one-graph path's shape (the Ising grid)
    timed, and per shape ``{E, V, S, D, ms, device_ms, bound_ms,
    plain_ms, torch_ms, torch_device_ms}``, ``plain_ms`` the plain twin's
    and ``torch_ms`` the torch prelude's (``messages.edge_prelude``)."""
    served = served or {}

    def serving_err(name):
        return [r["max_abs_err"] for r in served.get(name, ())]

    def shape(name, row):
        return dict(shape=name, E=row["E"], S=row["S"], ms=row["ms"],
                    device_ms=row["device_ms"], bound_ms=row["bound_ms"],
                    plain_ms=row["plain_ms"])

    kernels = []
    for semiring in ("sum", "max"):
        t = timing[f"main/{semiring}"]
        shapes = [shape("main", t),
                  shape("protein", timing[f"protein/{semiring}"])]
        for name in ("stereo", "zoo"):
            row = btiming[name]
            shapes.append(shape(name, dict(row["e"][semiring], E=row["E"],
                                           S=row["S"])))
        err = max([worst[semiring]] + [r["e"][semiring]["max_abs_err"]
                                       for r in btiming.values()
                                       if "e" in r]
                  + serving_err(f"fused_update_e/{semiring}"))
        kernels.append(dict(
            name=f"fused_update_e/{semiring}", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES[semiring],
            launches=launches[semiring],
            launches_by_path=by_path[f"fused_update_e/{semiring}"],
            max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None, shapes=shapes))
    t = btiming["stereo"]
    err = max([worst_t, timing["main/t"]["max_abs_err"]]
              + [r["max_abs_err"] for r in btiming.values()
                 if "max_abs_err" in r] + serving_err("fused_update_t/sum"))
    shapes = [shape("main", timing["main/t"]),
              shape("protein", btiming["protein"]), shape("stereo", t),
              shape("zoo", btiming["zoo"])]
    kernels.append(dict(
        name="fused_update_t/sum", route="cuda", source=T_SOURCE,
        replaces=T_REPLACES, launches=launches_t,
        launches_by_path=by_path["fused_update_t/sum"], max_abs_err=err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, shapes=shapes))
    if prelude is not None:
        t = prelude["ising1000"]
        kernels.append(dict(
            name="edge_prelude", route="cuda", source=PRELUDE_SOURCE,
            replaces=PRELUDE_REPLACES, launches=launches["prelude"],
            launches_by_path=by_path["edge_prelude"], max_abs_err=0.0,
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes", library_ms=None,
            shapes=[dict(shape=name, **{k: r[k] for k in (
                "E", "V", "S", "D", "ms", "device_ms", "bound_ms",
                "plain_ms", "torch_ms", "torch_device_ms")})
                for name, r in prelude.items()]))
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    t_start = time.perf_counter()

    log("== 1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, f32 = card_peaks(kind)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {kind} x{torch.cuda.device_count()}")

    log("== 2. build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(reports) or 'nothing (cached)'} in {build_s:.2f} s")
    # phase 24's host counts need no card: they run beside phases 3-23
    counts = start_counts(REPO / "chiprun_out" / "dryrun_torch")

    log("== 3. kernel vs plain version on the card")
    worst = phase_kernels(device)

    log("== 4. main path at full size")
    pgm, res, main = phase_main(device)
    log(f"  {main['graph']}: E={main['n_edges']} V={main['n_vertices']} "
        f"rounds={main['rounds']} converged={main['converged']} "
        f"max_residual={main['max_residual']:.3g} "
        f"{main['ms_per_round']:.3f} ms/round "
        f"launches={main['launches']['sum']}")

    log("== 5. paper-size runs")
    paper, mapd = phase_paper(device)

    log("== 6. card vs CPU")
    cpu = phase_card_vs_cpu(device)
    log(f"  {cpu['graph']} LBP: rounds={cpu['rounds']} on both, max belief "
        f"diff {cpu['max_prob_diff']:.3g}")

    log("== 7. timing (CUDA events, warm)")
    from repro_torch.pgm import protein_like_graph
    timing = phase_timing(pgm, device, bw, f32,
                          protein_like_graph(seed=0, device=device))
    log("  library_ms: null -- no single PyTorch call computes the fused "
        "update")

    log("== 8. device trace of the main path (torch.profiler)")
    trace = phase_trace(pgm, device)
    log(f"  {trace['rounds']} rounds: {trace['wall_ms_per_round']:.3f} ms/round "
        f"wall (no profiler), device busy {trace['device_ms_per_round']:.3f} "
        f"ms/round = share {trace['busy_share']:.3f}, "
        f"{trace['kernels_per_round']:.1f} kernels/round")
    for name, ms in trace["top_ms_per_round"].items():
        log(f"  {ms:.4f} ms/round  {name[:110]}")

    main_pgm, main_res = pgm, res       # phases 16 and 17 run them again
    del pgm, res

    log("== 9. TPU-layout kernel vs plain version on the card")
    worst_t = phase_kernels_t(device)

    log("== 10. batched main path at full size (run_many, stereo bucket)")
    batch, bmain = phase_batched(device)
    log(f"  {bmain['graph']}: B={bmain['batch']} E={bmain['n_edges']} per "
        f"graph S={bmain['n_states']}: run_many {bmain['run_many_s']:.3f} s "
        f"= bucketing {bmain['bucketing_s']:.3f} s + loop "
        f"{bmain['loop_s']:.3f} s; {bmain['iterations']} iterations, "
        f"{bmain['ms_per_iteration']:.3f} ms/iteration, "
        f"launches={bmain['launches']}, peak memory "
        f"{bmain['peak_memory_bytes'] / 2**30:.2f} GiB")
    for i, f in enumerate(bmain["frames"]):
        log(f"  frame {i}: rounds={f['rounds']} converged={f['converged']} "
            f"max_residual={f['max_residual']:.3g} argmax within 1 of truth "
            f"{f['within_1_of_truth']:.4f}")
    log(f"  slot 0 bitwise equal to its solo run ({bmain['solo_rounds']} "
        "rounds)")

    log("== 11. zoo stream: both bucket paths vs the CPU's plain path")
    zoo = phase_zoo(device)

    log("== 12. TPU-layout kernel vs plain version at the buckets' shapes; "
        "batched timing (CUDA events, warm)")
    from repro_torch.core import BatchedPGM
    btiming = phase_timing_batched(batch, {
        "zoo": widest_bucket(device),
        "protein": BatchedPGM.from_pgms([protein_like_graph(
            seed=0, device=device)])}, device, bw, f32)

    prelude = phase_prelude({
        "tsukuba": (batch.graph(0), rnbp_messages(batch.graph(0), device)),
        "tsukuba_x4": (batch.folded(), rnbp_messages(batch, device)),
        "ising1000": (main_pgm, rnbp_messages(main_pgm, device))},
        device, bw)

    protein_t = phase_protein_pallas(device)
    log(f"  {protein_t['graph']} RnBP through \"pallas\": rounds="
        f"{protein_t['rounds']} converged={protein_t['converged']} "
        f"fused_update_t launches={protein_t['launches']}")

    log("== 13. device trace of the batched path (torch.profiler)")
    btrace = phase_trace(batch, device, warm=16, config=batched_config(),
                         rng=0)
    log(f"  {btrace['rounds']} rounds: {btrace['wall_ms_per_round']:.3f} "
        f"ms/round wall (no profiler), device busy "
        f"{btrace['device_ms_per_round']:.3f} ms/round = share "
        f"{btrace['busy_share']:.3f}, {btrace['kernels_per_round']:.1f} "
        "kernels/round")
    for name, ms in btrace["top_ms_per_round"].items():
        log(f"  {ms:.4f} ms/round  {name[:110]}")

    log("== 14. serving path at full size (serve_async: stereo frames and "
        "the zoo stream, online)")
    serving = phase_serving(device)
    log_serving(serving)

    log("== 15. router tier at full size (serve_routed: two replicas, a "
        "CUDA stream each)")
    router = phase_router(device)
    log_router(router, serving)

    log("== 16. resilient runs and the serial baseline")
    resil = phase_resilient(device, main_pgm, main_res, paper,
                            REPO / "chiprun_out" / "resilient_ckpt")
    log_resilient(resil)

    log("== 17. multi-device paths (repro_torch.dist, rank-resident: a "
        "world of one over NCCL, gloo ranks sharing the card, the stereo "
        "bucket over them)")
    t0 = time.perf_counter()
    dist_out = dict(
        one=phase_dist_one(device, main_pgm, main_res,
                           REPO / "chiprun_out" / "dist_store"),
        gloo=phase_dist_gloo(device, REPO / "chiprun_out" / "dist_gloo"),
        main_ms_per_round=main["ms_per_round"])
    dist_out["phase_s"] = time.perf_counter() - t0
    log_dist(dist_out)
    del main_pgm, main_res

    log("== 18. the LM stack's serving path (repro_torch.models, "
        "launch.serve): every family card vs CPU, Qwen3-4B")
    lm = phase_lm(device, bw=bw)
    log_lm(lm)

    log("== 19. the LM stack's training path (forward_train, AdamW, the "
        "train step, SyntheticLM): every family card vs CPU, Qwen3-4B")
    lm_train = phase_lm_train(device)
    log_lm_train(lm_train)

    log("== 20. the LM stack's sharded serving path (launch.sharding, "
        "tensor-parallel prefill and decode, MoE \"sharded\"): reduced "
        "families on meshes, Granite-MoE 3B")
    t0 = time.perf_counter()
    lm_shard = phase_lm_shard(device, REPO / "chiprun_out" / "lm_shard",
                              bw=bw)
    lm_shard["phase_s"] = time.perf_counter() - t0
    log_lm_shard(lm_shard)
    log(f"  phase 20 in {lm_shard['phase_s']:.1f} s")

    log("== 21. the LM stack's sharded training path (tensor-parallel and "
        "ZeRO-3 train steps, sharded checkpoints' placement): the CPU "
        "tests' cases on meshes, Granite-MoE 3B trained over two ranks")
    t0 = time.perf_counter()
    lm_strain = phase_lm_strain(device, REPO / "chiprun_out" / "lm_strain")
    lm_strain["phase_s"] = time.perf_counter() - t0
    log_lm_strain(lm_strain)
    log(f"  phase 21 in {lm_strain['phase_s']:.1f} s")

    log("== 22. tensor parallelism of the SSM, hybrid, MLA and "
        "encoder-decoder blocks: Mamba2-130M over two ranks; Hymba, "
        "DeepSeek-V3 and Whisper widths at two layers")
    t0 = time.perf_counter()
    lm_blocks = phase_lm_blocks(device, REPO / "chiprun_out" / "lm_blocks",
                                bw=bw)
    lm_blocks["phase_s"] = time.perf_counter() - t0
    log_lm_blocks(lm_blocks)
    log(f"  phase 22 in {lm_blocks['phase_s']:.1f} s")

    log("== 23. serving over sub-meshes (\"sharded\"): four gloo ranks, "
        "two sub-meshes of two; serve_async with wall-clock decisions, "
        "serve_routed with a replica a sub-mesh")
    t0 = time.perf_counter()
    submesh = phase_submesh(device, REPO / "chiprun_out" / "submesh")
    submesh["phase_s"] = time.perf_counter() - t0
    log_submesh(submesh)
    log(f"  phase 23 in {submesh['phase_s']:.1f} s")

    log("== 24. the cost counters (roofline.op_cost, kernel_model."
        "round_cost, launch.dryrun): counted rounds through the kernels' "
        "dispatcher ops, Qwen3-4B's train step on fake tensors, the dry run")
    t0 = time.perf_counter()
    costs = phase_round_cost(device, batch,
                             round_parts_ms(btiming["round_parts_ms"]),
                             lm_train["trained"]["peak_memory_bytes"],
                             counts)
    costs["phase_s"] = time.perf_counter() - t0
    log_round_cost(costs)
    log(f"  phase 24 in {costs['phase_s']:.1f} s")

    log("== 25. the entry points (repro_torch.examples: quickstart, "
        "stereo_bp, ldpc_decode, bp_serving, train_lm in this process; "
        "distributed_bp in phase 17's gloo world)")
    t0 = time.perf_counter()
    entry = phase_entry_points(device)
    entry["phase_s"] = time.perf_counter() - t0
    entry["distributed_bp"] = dist_out["gloo"]["entry"]
    log_entry_points(entry)
    log(f"  phase 25 in {entry['phase_s']:.1f} s")

    log("== 26. the docs' executable spec (docs/torch/*.md on the card, "
        "sharding.md on an NCCL world of one) and README's first port "
        "block at full size")
    t0 = time.perf_counter()
    docs = phase_docs(device)
    docs["phase_s"] = time.perf_counter() - t0
    log_docs(docs)
    log(f"  phase 26 in {docs['phase_s']:.1f} s")

    checked = {name: list(serving["kernel_check"].get(name, []))
               + list(router["kernel_check"].get(name, []))
               for name in ("fused_update_e/sum", "fused_update_t/sum")}
    checked["fused_update_e/sum"] += [resil["resilient"],
                                      dist_out["one"]["sharded"]
                                      ["kernel_check"],
                                      dist_out["one"]["banded"]
                                      ["kernel_check"]]
    checked["fused_update_e/sum"] += submesh["kernel_check"]
    for name, err in docs["kernel_check"].items():
        checked.setdefault(name, []).append({"max_abs_err": err})
    paths = (main, mapd, bmain, serving, router, resil["resilient"],
             dist_out["one"], lm, lm_train, lm_shard, lm_strain, lm_blocks,
             submesh, costs, entry, docs)
    by_path = launches_by_path(*paths)
    by_path["edge_prelude"] = prelude_by_path(*paths)
    kernels = kernels_line(
        timing, btiming, worst, worst_t,
        {"sum": main["launches"]["sum"], "max": mapd["launches"],
         "prelude": main["launches"]["prelude"]},
        bmain["launches"], by_path, checked, prelude=prelude)
    report = dict(card=smi, device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  kernel_check=worst, main=main, paper=paper, map=mapd,
                  card_vs_cpu=cpu, timing=timing, trace=trace,
                  kernel_check_t=worst_t, batched=bmain, zoo=zoo,
                  batched_timing=btiming, prelude=prelude,
                  protein_pallas=protein_t,
                  batched_trace=btrace, serving=serving, router=router,
                  resilient=resil, dist=dist_out, lm=lm, lm_train=lm_train,
                  lm_shard=lm_shard, lm_strain=lm_strain,
                  lm_blocks=lm_blocks, submesh=submesh, round_cost=costs,
                  entry_points=entry, docs=docs,
                  peak_memory_bytes=torch.cuda.max_memory_allocated(),
                  total_s=time.perf_counter() - t_start, kernels=kernels)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    log(f"== done in {report['total_s']:.1f} s (total_s)")
    log(f"  edge_prelude launches by path: {by_path['edge_prelude']}")
    check_prelude_launches(by_path)
    print(smi)
    print(json.dumps({"docs": docs_line(docs)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
