"""LDPC decoding over AWGN: BER-vs-SNR for max-product BP vs uncoded.

The paper motivates BP with error-correcting codes; this driver closes the
loop: a regular (n, dv, dc) Gallager code is encoded as a pairwise PGM
(``repro_torch.pgm.ldpc_code`` -- check constraints become auxiliary
vertices with even-parity states), the channel is BPSK over AWGN, and
decoding is the *unchanged* engine with a max-product backend --
scheduling is semiring-agnostic, so the whole scheduler/serving stack
decodes codes without modification. On the card the update is the fused
kernel (``make_triton_update(semiring="max")``, bitwise ``"maxprod"``); on
the CPU it is ``"maxprod"``.

For each SNR point the all-zero codeword is transmitted ``--words`` times
with fresh noise; the coded bit-error rate (max-product MAP + argmax
beliefs) is compared against the uncoded hard-decision BER on the same
received samples. The coded curve must drop below uncoded -- that gap is
the decoder doing real work.

Run:  PYTHONPATH=src python -m repro_torch.examples.ldpc_decode [--words 8]
          [--snr 1.0,2.0,3.0] [--n 48] [--scheduler rbp] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import BPConfig, BPEngine, list_schedulers
from repro_torch.core.graph import resolve_device
from repro_torch.core.messages import map_assignment
from repro_torch.examples import generator, max_backend
from repro_torch.pgm import ldpc_code


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48, help="code length (bits)")
    ap.add_argument("--dv", type=int, default=3, help="bit degree")
    ap.add_argument("--dc", type=int, default=6, help="check degree")
    ap.add_argument("--words", type=int, default=8,
                    help="codewords simulated per SNR point")
    ap.add_argument("--snr", type=str, default="1.0,2.0,3.0",
                    help="comma-separated SNR points (dB)")
    ap.add_argument("--scheduler", default="lbp", choices=list_schedulers())
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def run(args) -> dict:
    """The BER table: one row per SNR point with ``uncoded_ber``,
    ``coded_ber``, ``converged`` (words), ``rounds`` (each word's) and
    ``wall_s``; ``rate`` beside it."""
    device = resolve_device(args.device)
    engine = BPEngine(BPConfig(scheduler=args.scheduler,
                               backend=max_backend(device), eps=1e-4,
                               max_rounds=args.max_rounds, history=False),
                      device=device)
    rows = []
    for snr_db in [float(s) for s in args.snr.split(",")]:
        t0 = time.perf_counter()
        coded = uncoded = bits = conv = 0
        rounds = []
        for w in range(args.words):
            inst = ldpc_code(args.n, dv=args.dv, dc=args.dc, snr_db=snr_db,
                             seed=1000 * w + 7, device=device)
            res = engine.run(inst.pgm, generator(device, w))
            decoded = map_assignment(inst.pgm, res.logm).cpu().numpy()
            coded += inst.coded_errors(decoded)
            uncoded += inst.uncoded_errors
            bits += inst.n_bits
            conv += int(bool(res.converged))
            rounds.append(int(res.rounds))
        rows.append(dict(snr_db=snr_db, uncoded_ber=uncoded / bits,
                         coded_ber=coded / bits, converged=conv,
                         rounds=rounds, wall_s=time.perf_counter() - t0))
    return dict(rate=1.0 - args.dv / args.dc, rows=rows)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"({args.n},{args.dv},{args.dc}) regular LDPC, rate "
          f"{1.0 - args.dv / args.dc:.2f}, {args.words} words/point, "
          f"scheduler={args.scheduler}")
    print(f"{'snr_db':>7} {'uncoded_ber':>12} {'coded_ber':>10} "
          f"{'conv':>6} {'rounds':>7} {'wall_s':>7}")
    out = run(args)
    for r in out["rows"]:
        print(f"{r['snr_db']:7.1f} {r['uncoded_ber']:12.4f} "
              f"{r['coded_ber']:10.4f} {r['converged']:3d}/{args.words:<2d} "
              f"{np.mean(r['rounds']):7.1f} {r['wall_s']:7.2f}")
    return out


if __name__ == "__main__":
    main()
