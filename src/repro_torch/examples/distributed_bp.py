"""Multi-device BP over a ``torch.distributed`` world.

Demonstrates both multi-device paths of ``repro_torch.dist``:

- **sharded**: each rank keeps and updates its slice of the edge axis, the
  per-vertex sums folded from rank to rank in the one-device order; works
  for any graph and any scheduler, bitwise the one-device run;
- **banded**: contiguous edge bands + neighbour-only halo exchange; only
  for banded graphs (grids/chains) but round-exact vs the one-device loop.

The world is one process per rank: the initialized one, else torchrun's,
else a world of one (``launch.train.launch_world``): gloo on the CPU,
NCCL when every rank has a GPU of its own, gloo staged through the host
when ranks share one. Every rank runs the same calls; rank 0 prints. On
the card each rank's slice runs the fused kernel ``fused_update_e``, and
the one-device runs ``"triton"``.

Run:
  PYTHONPATH=src torchrun --nproc-per-node 2 \\
      -m repro_torch.examples.distributed_bp [--size N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.core import LBP, BPConfig, BPEngine, RnBP
from repro_torch.core.graph import resolve_device
from repro_torch.dist import make_bp_mesh, run_bp_sharded
from repro_torch.dist.bp_banded import partition_banded, run_bp_banded
from repro_torch.examples import generator, sum_backend, sync
from repro_torch.launch.train import launch_world, rank_device
from repro_torch.pgm import ising_grid_fast

EPS, MAX_ROUNDS = 1e-3, 6000


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32,
                    help="Ising grid side (default 32; paper-ish scale 48+)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def _diff(pgm, a, b) -> float:
    return float(torch.where(pgm.state_mask, a - b, 0.0).abs().max())


def run(args, log=lambda *a, **k: None) -> dict:
    """The sharded and banded runs on this rank of the world (made here if
    there is none). ``log`` receives each line as it is known. Returns the
    world's size, the one-device RnBP and LBP results (``one``), each
    sharded run (``sharded``: name -> result, ``wall_s``, its belief diff
    against the one-device RnBP run) and the banded LBP run (``banded``:
    ``logm``, ``rounds``, ``converged``, ``parity``, ``wall_s``)."""
    device = rank_device(resolve_device(args.device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with launch_world(device):
        world = dist.get_world_size()
        log(f"devices: {world}")
        mesh = make_bp_mesh(device=device)
        pgm = ising_grid_fast(args.size, 2.5, seed=0, device=device)
        log(f"Ising {args.size}x{args.size}: {pgm.n_real_edges} directed "
            f"edges over {mesh.size()} shards")

        def one_device(spec, kwargs):
            return BPEngine(BPConfig(
                scheduler=spec, scheduler_kwargs=kwargs,
                backend=sum_backend(device), eps=EPS,
                max_rounds=MAX_ROUNDS), device=device).run(
                    pgm, generator(device, 0))
        ref = one_device("rnbp", {"low_p": 0.7})
        log(f"single-device RnBP: rounds={int(ref.rounds)} "
            f"converged={bool(ref.converged)}")

        sharded = {}
        for sched in [LBP(), RnBP(low_p=0.7)]:
            name = type(sched).__name__
            t0 = time.perf_counter()
            res = run_bp_sharded(pgm, sched, mesh, generator(device, 0),
                                 eps=EPS, max_rounds=MAX_ROUNDS,
                                 device=device)
            sync(device)
            wall = time.perf_counter() - t0
            diff = _diff(pgm, res.beliefs, ref.beliefs)
            sharded[name] = dict(result=res, wall_s=wall, diff=diff)
            log(f"sharded {name:5s}: rounds={int(res.rounds):5d} "
                f"converged={bool(res.converged)} "
                f"max-belief-diff-vs-ref={diff:.2e} wall={wall:.2f}s")

        # Banded halo-exchange path: round-exact LBP on the same grid.
        lbp_ref = one_device("lbp", {})
        part = partition_banded(pgm, mesh.size())
        t0 = time.perf_counter()
        logm, rounds, done = run_bp_banded(part, LBP(), mesh, 0, eps=EPS,
                                           max_rounds=MAX_ROUNDS)
        sync(device)
        wall = time.perf_counter() - t0
        parity = int(rounds) == int(lbp_ref.rounds)
        log(f"banded  LBP  : rounds={int(rounds):5d} converged={bool(done)} "
            f"round-parity-vs-ref={parity} wall={wall:.2f}s")
        return dict(world=world, one=dict(RnBP=ref, LBP=lbp_ref),
                    sharded=sharded,
                    banded=dict(logm=logm, rounds=int(rounds),
                                converged=bool(done), parity=parity,
                                wall_s=wall))


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve_device(args.device)

    def log(line):
        if dist.get_rank() == 0:
            print(line, flush=True)
    return run(args, log=log)


if __name__ == "__main__":
    main()
