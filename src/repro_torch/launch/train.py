"""Training launcher on one device (a port of ``repro.launch.train``).

Drives the train step with the features of the reference's launcher: an
elastic mesh over the ``torch.distributed`` world, checkpoint/restore with
exact data-cursor resume (checkpoints in the reference's layout, so either
package resumes the other's), straggler monitoring, cosine LR and
microbatch gradient accumulation. Without a process group it makes a world
of one (a ``FileStore`` in a temporary directory, gloo on the CPU, NCCL on
the GPU) and tears it down at the end. ``--model-parallel`` above 1 is
sharded training, not ported yet (ROADMAP queue 1, item 14c-2).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      [--device cpu]
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
from repro_torch.data import SyntheticLM
from repro_torch.ft import ElasticMesh, StragglerMonitor
from repro_torch.models import build_model
from repro_torch.train.step import (init_train_state, load_reference_tree,
                                    make_train_step, reference_like,
                                    reference_tree)

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
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 is sharded training, which is not "
            "ported yet (ROADMAP queue 1, item 14c-2)")

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    device = model.device
    shape = dataclasses.replace(TRAIN_4K, seq_len=args.seq,
                                global_batch=args.batch)
    pipe = SyntheticLM(cfg, shape, device=device)

    elastic = ElasticMesh(model_parallel=args.model_parallel, device=device)
    monitor = StragglerMonitor()
    step_fn = make_train_step(model, base_lr=args.lr, warmup=10,
                              total_steps=args.steps,
                              microbatches=args.microbatches)

    with world_of_one(device):
        mesh = elastic.current()
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{device}", flush=True)
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(0))
        start = 0
        if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
            tree, extra = restore_pytree(args.ckpt_dir, s,
                                         reference_like(state))
            load_reference_tree(state, tree)
            start = extra["data_step"]
            print(f"resumed from step {start}", flush=True)

        for i in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pipe.batch(i))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            straggler = monitor.record(time.perf_counter() - t0)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"dt={monitor.ewma:.2f}s"
                      + (" [straggler]" if straggler else ""), flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save_pytree(args.ckpt_dir, i + 1, reference_tree(state),
                            extra={"data_step": i + 1})
        print(f"done; straggler events: {monitor.events}")
    return state


if __name__ == "__main__":
    main()
