"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, counted
without hardware (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 placeholder TPU
devices and reads XLA's cost and memory analyses. The port has no compiler
to ask, so it runs the cell as rank 0 of a fake world and counts what rank
0 does:

- the world is torch's fake process group (``init_process_group("fake")``)
  of 256 ranks laid out ``(16, 16)`` over ("data", "model"), or 512 laid
  out ``(2, 16, 16)`` over ("pod", "data", "model")
  (``launch.mesh.make_production_mesh``): collectives return at once and
  move nothing;
- parameters, train state, caches and batches are fake tensors
  (``FakeTensorMode``) laid out by the port's sharding rules
  (``build_model(cfg, mesh=...)``, ``init_cache``): shapes without memory,
  so no device is touched. They are ``cuda`` tensors where torch is built
  for CUDA, and ``cpu`` ones on a CPU-only build (views, autograd and
  ``as_tensor`` of a ``cuda`` tensor need the device's runtime), which
  count the same: the BP update takes the kernel's op on fake tensors
  (``dist.slice_update``);
- one train step, prefill or decode step runs under ``roofline.op_cost``'s
  ``OpCounter`` with its live-bytes tracker, and ``dist.comm`` counts the
  collectives' bytes (``roofline.analysis.collective_bytes``).

The counts are rank 0's real work, replicated parts included. The
reference's are the global program's divided by the device count; each
record holds both the port's per-device figures and that division, from
the same step counted on one fake device (``global_over_devices``).

BP cells (``BP_CELLS``, as the reference's): ``ising_grid_fast(512, 2.5)``
and ``chain_graph(1_000_000)`` under RnBP(low_p=0.7) at eps 1e-3, on the
port's rank-resident ``"sharded"`` backend and on ``bp_banded``, each rank
one band. The graph is built on the host and its rank-0 share (the
rank-resident slice, or the band) made fake; the cell is one round's cost
times ``BP_ROUNDS`` (the reference's ``while_trips=100``), so no host read
of ``done`` is needed. The fused kernel is charged by its cost model
(``kernels._dispatch``).

Data-dependent shapes: the ragged MoE dispatch reads its per-expert group
sizes on the host, which a fake tensor cannot give; on fake tensors it
takes balanced groups (tokens * top_k / n_experts each,
``models.layers.moe``), as the reference's static shapes do, and such a
cell records ``"assumed": "balanced routing"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b \\
      --shape train_4k [--sharding fsdp] [--microbatches 4]
One JSON per cell under ``experiments/dryrun_torch/``; the exit code is 1
if any cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from repro_torch.configs import ARCH_IDS, get
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.op_cost import OpCounter, tensors_of

__all__ = ["BP_CELLS", "BP_ROUNDS", "fake_world", "lm_cell", "bp_cell",
           "run_cell", "main"]

BP_CELLS = ("bp_ising_512", "bp_chain_1m", "bp_ising_512_banded",
            "bp_chain_1m_banded")
#: rounds a BP cell is charged for (the reference's ``while_trips``)
BP_ROUNDS = 100


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks (torch's
    ``"fake"`` backend: collectives move nothing), replacing any other."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _mesh_device() -> str:
    # the mesh only names a device type; its groups are the fake world's
    return "cuda" if torch.cuda.is_available() else "cpu"


def _fake_device() -> str:
    """Where a cell's fake tensors say they are (see the module
    docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _float_masters(model) -> Dict[str, torch.Tensor]:
    """``init_train_state``'s float32 masters of a model of fake tensors,
    values not drawn: each floating parameter replaced by its float32 copy
    (``model.float()`` swaps fake tensors, which a fake mode's references
    forbid), made to require grad."""
    for module in model.modules():
        for key, p in list(module._parameters.items()):
            if p is not None and p.is_floating_point():
                module._parameters[key] = nn.Parameter(p.float())
    return dict(model.named_parameters())


def _zeros(specs: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def _serve_batch(cfg, shape, device) -> Dict[str, torch.Tensor]:
    """The reference's prefill inputs (``input_specs``), global."""
    b, s = shape.global_batch, shape.seq_len
    dt = torch.bfloat16
    if cfg.frontend == "vision":
        t = cfg.n_frontend_tokens
        return {"frontend_embeds": torch.zeros((b, t, cfg.d_model), dtype=dt,
                                               device=device),
                "tokens": torch.zeros((b, s - t), dtype=torch.int32,
                                      device=device)}
    if cfg.frontend == "audio":
        return {"frontend_embeds": torch.zeros((b, s, cfg.d_model), dtype=dt,
                                               device=device),
                "tokens": torch.zeros((b, 1), dtype=torch.int32,
                                      device=device)}
    return {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device)}


def _storages(tree) -> Dict[int, int]:
    """{storage id: bytes} of ``tree``'s tensors."""
    out = {}
    for t in tensors_of(tree):
        st = t.untyped_storage()
        out[st._cdata] = int(st.nbytes())
    return out


@dataclasses.dataclass
class Count:
    """One counted step: the counter (``cost``, ``by_class``, ``live``),
    and the bytes of its arguments, of the results it made and of the
    rank's parameters (or train-state masters)."""
    counter: OpCounter
    argument_bytes: int = 0
    output_bytes: int = 0
    param_bytes: int = 0


def _count(fn, args: tuple, held=(), *, live: bool = True) -> Count:
    """Count ``fn(*args)``; ``held``: tensors it reads that are not in
    ``args`` (a model's parameters)."""
    counter = OpCounter(live=live)
    inputs = _storages((args, held))
    counter.hold((args, held))
    with counter:
        out = fn(*args)
    made = {k: n for k, n in _storages(out).items() if k not in inputs}
    return Count(counter, sum(inputs.values()), sum(made.values()))


def _count_lm(cfg, shape, mesh, mode: str, microbatches: int,
              live: bool = True) -> Count:
    """Count one step of ``cfg`` at ``shape`` on ``mesh`` (None: one
    device), on fake tensors."""
    from repro_torch.data import make_batch_specs
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import TrainState, make_train_step
    train = shape.kind == "train"
    device = _fake_device()
    with _fake_mode():
        model = build_model(cfg, device=device, mesh=mesh,
                            mode=mode if train else "tp")
        if train:
            params = _float_masters(model)
            state = TrainState(params=params, opt=adamw_init(params),
                               step=torch.zeros((), dtype=torch.int32,
                                                device=device))
            batch = _zeros(make_batch_specs(cfg, shape), device)
            step = make_train_step(model, microbatches=microbatches)
            count = _count(step, (state, batch), live=live)
        elif shape.kind == "prefill":
            count = _count(model.prefill,
                           (_serve_batch(cfg, shape, device),),
                           list(model.parameters()), live=live)
        else:
            b, s = shape.global_batch, shape.seq_len
            args = (model.init_cache(b, s),
                    torch.zeros((b, 1), dtype=torch.int32, device=device),
                    torch.full((), s - 1, dtype=torch.int32, device=device))
            count = _count(model.decode_step, args,
                           list(model.parameters()), live=live)
    count.param_bytes = sum(p.numel() * p.element_size()
                            for p in model.parameters())
    return count


def _record(count: Count, n_dev: int, model_flops: float, glob) -> dict:
    """The cell's record: the roofline report of rank 0's counts, its
    counts by op class, and the global count over the devices."""
    c = count.counter
    report = RA.analyze(
        flops=c.cost.flops, hbm_bytes=c.cost.bytes, n_devices=n_dev,
        coll=RA.collective_bytes(), model_flops_global=model_flops,
        argument_bytes=count.argument_bytes,
        output_bytes=count.output_bytes, peak_bytes=c.live.peak)
    return dict(**report.as_dict(),
                by_class={k: dataclasses.asdict(v)
                          for k, v in c.by_class.items()},
                global_over_devices={"flops": glob.flops / n_dev,
                                     "hbm_bytes": glob.bytes / n_dev})


def lm_cell(arch: str, shape_name: str, mesh, *, microbatches: int = 1,
            sharding_mode: str = "tp", moe_dispatch: str = "",
            global_counts: Optional[dict] = None) -> dict:
    """Count one LM cell on ``mesh`` (a production ``DeviceMesh`` of the
    fake world); returns the record's fields. ``global_counts`` caches the
    one-device counts across meshes."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import axes_group, data_axes
    from repro_torch.models.layers import moe
    from repro_torch.models.model import param_specs
    cfg = get(arch)
    if moe_dispatch and cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    key = (arch, shape_name, sharding_mode, microbatches, cfg.moe_dispatch)
    cache = global_counts if global_counts is not None else {}
    if key not in cache:
        # one device: "sharded" dispatch runs as "ragged" (the port's rule)
        one = cfg if cfg.moe_dispatch != "sharded" else \
            dataclasses.replace(cfg, moe_dispatch="ragged")
        moe.set_shard_mesh(None)
        cache[key] = _count_lm(one, shape, None, sharding_mode, microbatches,
                               live=False).counter.cost
    moe.set_shard_mesh(mesh if cfg.moe_dispatch == "sharded" else None)
    # the flattened groups of several axes, made now: a DeviceMesh computes
    # them from its rank tensor, which a fake mode would fake
    for axes in (data_axes(mesh), tuple(mesh.mesh_dim_names)):
        axes_group(mesh, axes)
    comm.reset_stats()
    count = _count_lm(cfg, shape, mesh, sharding_mode, microbatches)
    kind = shape.kind
    n_tokens = shape.global_batch * (1 if kind == "decode" else
                                     shape.seq_len)
    mf = RA.model_flops(param_specs(cfg), n_tokens, cfg=cfg, kind=kind)
    rec = dict(kind=kind, **_record(count, mesh.size(), mf, cache[key]),
               param_bytes=count.param_bytes, fake_device=_fake_device())
    if cfg.n_experts and cfg.moe_dispatch in ("ragged", "sharded"):
        rec["assumed"] = "balanced routing"
    return rec


def _faked(obj, mode, device):
    """``obj`` (a graph, a slice plan: dataclasses of tensors) with every
    tensor field a fake tensor of ``mode`` on ``device``."""
    if isinstance(obj, torch.Tensor):
        with mode:
            return torch.empty_strided(obj.shape, obj.stride(),
                                       dtype=obj.dtype, device=device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _faked(getattr(obj, f.name), mode, device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _stats():
    """A copy of ``dist.comm``'s counts (``STATS``, ``GROUP_BYTES``)."""
    from repro_torch.dist import comm
    return dict(comm.STATS), dict(comm.GROUP_BYTES)


def _scaled(stats, k: float, minus=None):
    """``k`` times ``stats`` less ``minus`` (pairs as ``_stats`` gives)."""
    minus = minus or ({}, {})
    return tuple({key: k * (v - m.get(key, 0)) for key, v in part.items()}
                 for part, m in zip(stats, minus))


def bp_cell(name: str, mesh) -> dict:
    """Count one BP cell (``BP_CELLS``) over the fake world's ranks as one
    "bp" axis: one round of rank 0 times ``BP_ROUNDS``; returns the
    record's fields."""
    from repro_torch import dist as D
    from repro_torch.core import RnBP
    from repro_torch.core.graph import pad_pgm
    from repro_torch.dist import comm
    from repro_torch.kernels.ops import make_triton_update
    from repro_torch.pgm import chain_graph, ising_grid_fast
    from repro_torch.roofline.kernel_model import engine_round, round_cost
    n_dev = mesh.size()
    pgm = ising_grid_fast(512, 2.5, seed=0, device="cpu") if "ising" in name \
        else chain_graph(1_000_000, C=10.0, seed=0, device="cpu")
    sched = RnBP(low_p=0.7)
    bp_mesh = D.make_bp_mesh(device=_mesh_device())
    mode = _fake_mode()
    gen = torch.Generator().manual_seed(0)
    device = _fake_device()
    one = _faked(pgm, mode, device)
    with mode:          # the one-device round: the global count
        glob = round_cost(one, sched, make_triton_update(), eps=1e-3,
                          rng=gen) * BP_ROUNDS
    if name.endswith("_banded"):
        part = dataclasses.replace(D.partition_banded(pgm, n_dev), pgm=one)

        def run(rounds):
            comm.reset_stats()
            with mode:
                count = _count(lambda: D.run_bp_banded(
                    part, sched, bp_mesh, 0, eps=1e-3, max_rounds=rounds),
                    (), (one,))
            return count, _stats()
        first, first_stats = run(1)
        count, stats = run(2)
        # a round: the difference of two runs that share their set-up
        rnd = count.counter.cost - first.counter.cost
        stats = _scaled(stats, BP_ROUNDS, first_stats)
    else:
        # re-padded to even slices, as run_bp_sharded does
        need = -(-pgm.n_edges // (2 * n_dev)) * (2 * n_dev)
        padded = pgm if need == pgm.n_edges else pad_pgm(
            pgm, n_edges=need, n_vertices=pgm.n_vertices,
            n_states=pgm.n_states_max)
        spgm = _faked(D.shard_pgm(padded, bp_mesh, device="cpu"), mode,
                      device)
        comm.reset_stats()
        with mode:
            one_round, args = engine_round(spgm, sched,
                                           D.make_sharded_update(bp_mesh),
                                           eps=1e-3, rng=gen)
            count = _count(one_round, args, (spgm,))
        rnd = count.counter.cost
        stats = _scaled(_stats(), BP_ROUNDS)
    e, s = pgm.n_real_edges, pgm.n_states_max
    mf = float(BP_ROUNDS * e * (4 * s * s + 6 * s))
    total = rnd * BP_ROUNDS
    report = RA.analyze(
        flops=total.flops, hbm_bytes=total.bytes, n_devices=n_dev,
        coll=RA.collective_bytes(*stats), model_flops_global=mf,
        argument_bytes=count.argument_bytes,
        output_bytes=count.output_bytes, peak_bytes=count.counter.live.peak)
    return dict(kind="bp", **report.as_dict(),
                round={"flops": rnd.flops, "hbm_bytes": rnd.bytes},
                global_over_devices={"flops": glob.flops / n_dev,
                                     "hbm_bytes": glob.bytes / n_dev},
                fake_device=device, rounds=BP_ROUNDS)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
             microbatches: int = 1, quiet: bool = False,
             sharding_mode: str = "tp", tag: str = "",
             moe_dispatch: str = "",
             global_counts: Optional[dict] = None) -> dict:
    """Count one cell on the production mesh of a fake world, write its
    JSON under ``out_dir`` and print a line; a failure is recorded, not
    raised."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device=_mesh_device())
        if arch.startswith("bp_"):
            fields = bp_cell(arch, mesh)
        else:
            fields = lm_cell(arch, shape_name, mesh,
                             microbatches=microbatches,
                             sharding_mode=sharding_mode,
                             moe_dispatch=moe_dispatch,
                             global_counts=global_counts)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "ok", "count_s": round(time.time() - t0, 1),
               **fields}
    except Exception as e:                          # noqa: BLE001
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if not quiet:
        if rec["status"] == "ok":
            mem = rec["memory_per_device"]
            print(f"[ok] {arch:22s} {shape_name:12s} {mesh_name:8s} "
                  f"flops/dev={rec['flops']:.3e} "
                  f"bytes/dev={rec['hbm_bytes']:.3e} "
                  f"coll/dev={rec['coll_bytes']:.3e} "
                  f"bn={rec['bottleneck']:10s} "
                  f"useful={rec['useful_ratio']:.2f} "
                  f"peak={mem['peak_bytes']:.2e} "
                  f"fits80GB={mem['peak_ok_80GB']} t={rec['count_s']}s",
                  flush=True)
        else:
            print(f"[FAIL] {arch} {shape_name} {mesh_name}: {rec['error']}",
                  flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sharding", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--moe-dispatch", default="",
                    choices=["", "ragged", "dense", "sharded"])
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) + list(BP_CELLS) if args.arch == "all" \
        else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = n_cells = 0
    global_counts: dict = {}
    for arch in archs:
        if arch.startswith("bp_"):
            shapes = ["-"]
        else:
            cfg = get(arch)
            shapes = [s.name for s in cfg.shapes()] if args.shape == "all" \
                else args.shape.split(",")
        for shape_name in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape_name, mp, args.out,
                               microbatches=args.microbatches,
                               sharding_mode=args.sharding, tag=args.tag,
                               moe_dispatch=args.moe_dispatch,
                               global_counts=global_counts)
                n_cells += 1
                n_fail += rec["status"] != "ok"
    print(f"dry-run complete; cells: {n_cells}; failures: {n_fail}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
