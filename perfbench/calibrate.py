"""Readings that the check's limits are set from, on the card.

    python3 perfbench/calibrate.py --workload stereo_tsukuba.solo \
        --seeds 12 --control-seeds 3 --seconds 6 --out readings.json

In one process: the port on ``--seeds`` seeds at the cell's own sizes
and load (a short window, every call's answers held against the
reference), then the control -- the reference in the precision below the
configuration's, in the port's place -- on ``--control-seeds`` seeds.
Writes each run's readings (the worst of each number), its rounds and
whether it came out correct. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness
    from perfbench.control import Control
    bench = harness.Bench(ROOT)
    config = bench.config(bench.cell(args.workload)["config"])
    every = {"check_period_s": 1e-3}
    out = dict(workload=args.workload,
               device=torch.cuda.get_device_name(0), runs=[])
    for k in range(args.seeds + args.control_seeds):
        control = k >= args.seeds
        seed = args.first_seed + 7919 * k
        system = (Control("cuda:0", config["reference"], config["precision"])
                  if control else None)
        records = []
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               t_start=t0, device="cuda:0", system=system,
                               traffic_override=every, records=records)
        rec = records[0]
        run = dict(system="control" if control else "port", seed=seed,
                   correct=res["correct"], checks=res["checks"],
                   rounds=[c["rounds"] for c in rec["calls"]],
                   converged=[c["converged"] for c in rec["calls"]],
                   readings=rec["readings"], metrics=res["metrics"],
                   seconds=time.perf_counter() - t0)
        out["runs"].append(run)
        harness.log(json.dumps({k: run[k] for k in (
            "system", "seed", "correct", "checks", "seconds")}))
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
