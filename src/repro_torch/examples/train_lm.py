"""Train a small LM end-to-end through the production substrate.

Uses the same config/model/optimizer/data/checkpoint stack as the
multi-pod dry run, scaled down: a reduced qwen3-family model, a few
hundred steps, loss visibly decreasing, checkpoint + exact resume. The
resume drill restores the mid-run checkpoint into a second model and
train state, replays the remaining steps and prints the largest
difference between the two runs' parameters, which must be exactly 0.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 60]
          [--device cpu]
(Any assigned arch works: --arch granite_moe_3b_a800m trains the MoE.)
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.configs import get
from repro_torch.configs.base import TRAIN_4K
from repro_torch.core.graph import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.examples import generator, sync
from repro_torch.models import build_model
from repro_torch.train.step import (init_train_state, load_reference_tree,
                                    make_train_step, reference_like,
                                    reference_tree, train_state_specs)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def run(args, log=lambda *a, **k: None) -> dict:
    """Train ``args.steps`` steps with a checkpoint after step
    ``steps // 2``, then restore it into a fresh model and replay. ``log``
    receives each line as it is known. Returns ``name``, ``n_params``,
    ``losses`` (every step's), ``train_s`` and ``drift``."""
    device = resolve_device(args.device)
    cfg = get(args.arch).reduced()
    shape = dataclasses.replace(TRAIN_4K, seq_len=args.seq,
                                global_batch=args.batch)
    pipe = SyntheticLM(cfg, shape, device=device)

    def trainer():
        model = build_model(cfg, device=device)
        step = make_train_step(model, base_lr=2e-3, warmup=10,
                               total_steps=args.steps)
        return model, step, init_train_state(model, generator(device, 0))

    model, step, state = trainer()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {n_params / 1e6:.2f}M params (reduced config)")

    losses = []
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, m = step(state, pipe.batch(i))
            losses.append(float(m["loss"]))
            if i % 10 == 0 or i == args.steps - 1:
                log(f"step {i:4d} loss={losses[-1]:.4f} "
                    f"lr={float(m['lr']):.2e}", flush=True)
            if i == args.steps // 2:
                save_pytree(ckpt, i + 1, reference_tree(state),
                            extra={"data_step": i + 1})
        sync(device)
        train_s = time.perf_counter() - t0
        log(f"trained {args.steps} steps in {train_s:.1f}s")

        # crash-resume drill: restore mid-run checkpoint, replay, compare
        s = latest_step(ckpt)
        model2, step2, restored = trainer()
        tree, extra = restore_pytree(ckpt, s,
                                     reference_like(train_state_specs(model2)))
        load_reference_tree(restored, tree)
        for i in range(extra["data_step"], args.steps):
            restored, _ = step2(restored, pipe.batch(i))
        with torch.no_grad():
            drift = max(float((a.float() - restored.params[k].float())
                              .abs().max())
                        for k, a in state.params.items())
    log(f"checkpoint-resume replay drift: {drift:.2e} (exact = 0)")
    return dict(name=cfg.name, n_params=n_params, losses=losses,
                train_s=train_s, drift=drift)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve_device(args.device)
    return run(args, log=print)


if __name__ == "__main__":
    main()
