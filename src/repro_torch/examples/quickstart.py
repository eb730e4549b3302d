"""Quickstart: Randomized Belief Propagation on an Ising grid.

Reproduces the paper's core result in miniature: on a hard Ising grid,
synchronous (Loopy) BP stalls while RnBP's randomized frontier converges,
at the same per-round cost and with no sort-and-select overhead.

Everything routes through the unified engine: one serializable ``BPConfig``
(scheduler spec string + kwargs) drives ``BPEngine.run``; on the card its
backend is ``"triton"`` (the fused kernel ``fused_update_e``), on the CPU
the plain ``"ref"``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import BPConfig, BPEngine
from repro_torch.core.graph import resolve_device
from repro_torch.examples import generator, sum_backend, sync
from repro_torch.pgm import ising_grid

#: (row label, scheduler spec, kwargs): the reference's four engines
ENGINES = (
    ("LBP  (all messages)      ", "lbp", {}),
    ("RBP  (top-k, p=1/128)    ", "rbp", {"p": 1 / 128}),
    ("RnBP (random, LowP=0.4)  ", "rnbp", {"low_p": 0.4}),
    ("RnBP (random, LowP=0.1)  ", "rnbp", {"low_p": 0.1}),
)


def run(device, *, eps: float = 1e-3, max_rounds: int = 8000,
        engines=ENGINES) -> dict:
    """Each engine of ``engines`` on ``ising_grid(40, C=2.5, seed=2)``,
    then RnBP(low_p=0.4) once more for the marginals. Returns the graph's
    sizes, one row per engine (``converged``, ``rounds``, ``updates``,
    ``wall_s``) and ``marginals``, P(x_i = 1) of every real vertex."""
    device = resolve_device(device)
    # C controls difficulty (paper SSIII-C); this instance is in the regime
    # where synchronous LBP oscillates forever but randomized scheduling
    # converges (paper Fig 4b)
    pgm = ising_grid(40, C=2.5, seed=2, device=device)
    base = BPConfig(eps=eps, max_rounds=max_rounds,
                    backend=sum_backend(device))
    rows = []
    for name, spec, kwargs in engines:
        engine = BPEngine(base, scheduler=spec, scheduler_kwargs=kwargs,
                          device=device)
        t0 = time.perf_counter()
        res = engine.run(pgm, generator(device, 0))
        sync(device)
        rows.append(dict(name=name, converged=bool(res.converged),
                         rounds=int(res.rounds), updates=int(res.updates),
                         wall_s=time.perf_counter() - t0))
    engine = BPEngine(base, scheduler="rnbp", scheduler_kwargs={"low_p": 0.4},
                      device=device)
    res = engine.run(pgm, generator(device, 0))
    beliefs = np.exp(res.beliefs.cpu().numpy())[:pgm.n_real_vertices]
    return dict(n_vertices=pgm.n_real_vertices, n_edges=pgm.n_real_edges,
                rows=rows, marginals=beliefs[:, 1],
                rnbp=dict(rounds=int(res.rounds),
                          converged=bool(res.converged)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = run(device)
    print(f"Ising 40x40, C=2.5: {out['n_vertices']} vertices, "
          f"{out['n_edges']} directed edges")
    for r in out["rows"]:
        status = "converged" if r["converged"] else "STALLED  "
        print(f"{r['name']} {status} rounds={r['rounds']:5d} "
              f"committed-updates={r['updates']:10d} "
              f"wall={r['wall_s']:6.2f}s")
    print("\nfirst 5 marginals P(x_i = 1):", np.round(out["marginals"][:5], 4))
    return out


if __name__ == "__main__":
    main()
