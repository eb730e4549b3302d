"""Training launcher (a port of ``repro.launch.train``), on one device or a
("data", "model") mesh.

Drives the train step with the features of the reference's launcher: an
elastic mesh over the ``torch.distributed`` world, the train state placed
by ``train_state_shardings``, checkpoint/restore with exact data-cursor
resume (checkpoints in the reference's layout, gathered whole, so either
package resumes the other's, on any mesh), straggler monitoring, cosine LR
and microbatch gradient accumulation. ``--model-parallel`` sets the "model"
axis; ``--sharding`` picks the mode, ``tp`` (the reference launcher's:
tensor parallelism over "model", batch over "data") or ``fsdp`` (ZeRO-3
over both axes, the mode the reference's dry run lowers; a flag of the
port's own).

The world: the initialized one if there is one; else torchrun's (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment; each
rank on GPU ``LOCAL_RANK``, NCCL when every rank has a GPU of its own, gloo
when ranks share one, their exchanges staged through the host; gloo on the
CPU); else a world of one (a ``FileStore`` in a temporary directory), torn
down at the end. Every rank draws the same global batch (a pure function
of the seed and step) and keeps its rows. Only rank 0 prints.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch granite_moe_3b_a800m --model-parallel 2 [--sharding fsdp]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.configs import get
from repro_torch.configs.base import TRAIN_4K
from repro_torch.core.graph import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.ft import ElasticMesh, StragglerMonitor
from repro_torch.launch.sharding import train_state_shardings
from repro_torch.models import build_model
from repro_torch.train.step import (init_train_state, load_reference_tree,
                                    make_train_step, reference_like,
                                    reference_shardings, reference_tree,
                                    train_state_specs)

WORLD_TIMEOUT_S = 120


@contextlib.contextmanager
def world_of_one(device: torch.device):
    """The initialized ``torch.distributed`` world if there is one, else a
    world of one rank for the duration of the block."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            yield
        finally:
            dist.destroy_process_group()


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: on the GPU, card ``LOCAL_RANK`` modulo the cards
    there are (ranks beyond them share)."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


@contextlib.contextmanager
def launch_world(device: torch.device):
    """The world to train in: the initialized one, else torchrun's from
    the environment, else ``world_of_one``."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        with world_of_one(device):
            yield
        return
    size = int(os.environ["WORLD_SIZE"])
    own = device.type == "cuda" and size <= torch.cuda.device_count()
    dist.init_process_group(
        "nccl" if own else "gloo", init_method="env://",
        rank=int(os.environ["RANK"]), world_size=size,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--sharding", choices=("tp", "fsdp"), default="tp",
                    help="tp: tensor parallelism over 'model' (default); "
                         "fsdp: ZeRO-3 over ('data', 'model')")
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = rank_device(resolve_device(args.device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    shape = dataclasses.replace(TRAIN_4K, seq_len=args.seq,
                                global_batch=args.batch)
    pipe = SyntheticLM(cfg, shape, device=device)
    elastic = ElasticMesh(model_parallel=args.model_parallel, device=device)
    monitor = StragglerMonitor()

    with launch_world(device):
        lead = dist.get_rank() == 0
        log = print if lead else (lambda *a, **k: None)
        mesh = elastic.current()
        model = build_model(cfg, device=device, mesh=mesh,
                            mode=args.sharding)
        shardings = train_state_shardings(mesh, train_state_specs(model),
                                          args.sharding)
        on_disk = reference_shardings(shardings)
        step_fn = make_train_step(model, base_lr=args.lr, warmup=10,
                                  total_steps=args.steps,
                                  microbatches=args.microbatches,
                                  grad_shardings=shardings.params)
        log(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"({args.sharding}) on {device}, "
            f"{dist.get_world_size()} rank(s)", flush=True)
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(0))
        start = 0
        if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
            tree, extra = restore_pytree(
                args.ckpt_dir, s, reference_like(train_state_specs(model)),
                sharding_tree=on_disk, mesh=mesh)
            load_reference_tree(state, tree)
            start = extra["data_step"]
            log(f"resumed from step {start}", flush=True)

        for i in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pipe.batch(i))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            straggler = monitor.record(time.perf_counter() - t0)
            if i % args.log_every == 0 or i == args.steps - 1:
                log(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"dt={monitor.ewma:.2f}s"
                    + (" [straggler]" if straggler else ""), flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save_pytree(args.ckpt_dir, i + 1, reference_tree(state),
                            extra={"data_step": i + 1},
                            sharding_tree=on_disk, mesh=mesh)
        log(f"done; straggler events: {monitor.events}")
    return state


if __name__ == "__main__":
    main()
