"""Stereo-vision MRF: disparity decoding on a synthetic scene.

The paper motivates BP with vision workloads; this driver decodes a
truncated-linear stereo MRF (``repro_torch.pgm.stereo_mrf``: a slanted
disparity plane with a raised foreground rectangle, noisy observations,
the classic grid energy) with max-product BP through the unchanged engine
and scores the labeling two ways:

- **accuracy**: fraction of pixels within +-1 disparity of ground truth
  (the complement of the standard bad-pixel metric) -- must beat the raw
  rounded observation, i.e. the smoothness term must actually denoise;
- **energy**: the MAP objective. BP's labeling should reach at-or-below
  the *ground truth's* energy (noise makes truth slightly suboptimal
  under its own posterior -- matching it is the decoding win).

On the card the max-product update is the fused kernel
(``make_triton_update(semiring="max")``, bitwise ``"maxprod"``); on the
CPU it is ``"maxprod"``.

Run:  PYTHONPATH=src python -m repro_torch.examples.stereo_bp [--height 12]
          [--width 16] [--disp 8] [--scheduler rbp] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import BPConfig, BPEngine, list_schedulers
from repro_torch.core.graph import resolve_device
from repro_torch.core.messages import map_assignment
from repro_torch.examples import generator, max_backend
from repro_torch.pgm import stereo_mrf


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=12)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--disp", type=int, default=8,
                    help="disparity levels (states per pixel)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="rbp", choices=list_schedulers())
    ap.add_argument("--max-rounds", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def run(args, backend=None) -> dict:
    """Decode one scene; ``backend`` replaces the device's max-product
    backend (``examples.max_backend``). Returns ``converged``, ``rounds``,
    ``wall_s``, ``labels`` (H, W), the accuracies and the energies."""
    device = resolve_device(args.device)
    inst = stereo_mrf(args.height, args.width, args.disp, seed=args.seed,
                      device=device)
    engine = BPEngine(BPConfig(
        scheduler=args.scheduler,
        backend=max_backend(device) if backend is None else backend,
        eps=1e-4, max_rounds=args.max_rounds, history=False), device=device)
    t0 = time.perf_counter()
    res = engine.run(inst.pgm, generator(device, args.seed))
    n_pix = args.height * args.width
    labels = map_assignment(inst.pgm, res.logm)[:n_pix].cpu().numpy()
    wall = time.perf_counter() - t0
    obs_labels = np.clip(np.round(inst.obs), 0, args.disp - 1).astype(int)
    return dict(
        converged=bool(res.converged), rounds=int(res.rounds), wall_s=wall,
        labels=labels.reshape(args.height, args.width),
        accuracy=dict(observation=inst.accuracy(obs_labels),
                      bp=inst.accuracy(labels)),
        energy=dict(truth=inst.energy(inst.truth),
                    observation=inst.energy(obs_labels),
                    bp=inst.energy(labels)))


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    out = run(args)
    acc, en = out["accuracy"], out["energy"]
    print(f"stereo {args.height}x{args.width}x{args.disp} "
          f"scheduler={args.scheduler}: converged={out['converged']} "
          f"rounds={out['rounds']} wall={out['wall_s']:.2f}s")
    print(f"accuracy(+-1): observation={acc['observation']:.3f} "
          f"BP={acc['bp']:.3f}")
    print(f"energy: truth={en['truth']:.2f} "
          f"observation={en['observation']:.2f} "
          f"BP={en['bp']:.2f} (lower is better)")
    print("decoded disparity map (rows top to bottom):")
    for row in out["labels"]:
        print("  " + "".join(f"{d:x}" for d in row))
    return out


if __name__ == "__main__":
    main()
