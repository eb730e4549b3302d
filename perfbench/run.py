"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 perfbench/run.py --workload ising1000.solo --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. Prints progress and, as its last lines, each
number the check compared beside its limit on standard error, and the
result as one JSON object on the last line of standard output. Exits
non-zero with no result where there is no CUDA card (or fewer than the
cell asks for), or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _finite(x):
    """``x`` with every non-finite float as a string (JSON has no NaN)."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    # One intra-op thread: the run's host work is Python, numpy and kernel
    # launches, and torch's OpenMP workers would only compete with the
    # thread that launches, on a host whose cores other machines share.
    torch.set_num_threads(1)
    from perfbench import harness
    cell = harness.Bench(ROOT).cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"this machine has {have}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              device="cuda:0")
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules loaded in the run: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
