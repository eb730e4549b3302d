"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

- ``perfbench/configs/<config>.json``: the graph family (a module of
  ``perfbench/inputs``) and its sizes, the engine's settings, the
  reference (a module of ``perfbench/reference``), the precision, and the
  limit of each number the check compares;
- ``perfbench/traffic/<traffic>.json``: the mix, read by ``loadgen``;
- ``perfbench/metrics/<metric>.py``: a reader ``read(ctx)`` that returns
  the metric's value, or None where the run has nothing for it to read.

``run_cell`` takes the system under test as an argument (the port by
default), so the control and the tests' broken systems run through the
same code.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
import warnings
from pathlib import Path

import torch

from perfbench import loadgen
from perfbench.roofline import card_peaks, input_bytes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package (compared whole: the port's own name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The ``FORBIDDEN`` top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read(ctx)`` of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1,
                    memory_peak_bytes=torch.cuda.max_memory_allocated(device))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def _worst(values: list):
    """The largest reading, NaN if any is NaN, None if there is none."""
    if not values:
        return None
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def _one_call(system, engine, plan, graphs, sizes, i):
    """Call ``i`` of ``plan``: its record and its answers."""
    idx = plan.graphs(i)
    before = system.launches()
    t0 = time.perf_counter()
    results = system.call(engine, plan.kind, [graphs[j] for j in idx],
                          plan.call_seed(i))
    # the answer reaches the caller: marginals and counters on the host
    host = [(r.beliefs.cpu(), int(r.rounds), bool(r.converged))
            for r in results]
    wall = time.perf_counter() - t0
    after = system.launches()
    rec = dict(graphs=idx, wall_s=wall, rounds=[h[1] for h in host],
               converged=[h[2] for h in host],
               launches={k: after[k] - before[k] for k in after},
               update_bytes=sum(sizes[j] for j in idx))
    return rec, [(j, r.logm, h[0]) for j, r, h in zip(idx, results, host)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", system=None, root: Path = ROOT,
             config_override: dict | None = None,
             traffic_override: dict | None = None,
             records: list | None = None) -> dict:
    """One run of ``workload``; returns the result object (its last key,
    ``checks``, holds each number compared with its limit). ``records``,
    when given, receives each window call's record and every reading of
    the check (``perfbench/calibrate.py``)."""
    bench = Bench(root)
    cell = bench.cell(workload)
    config = _merge(bench.config(cell["config"]), config_override)
    plan = loadgen.Plan(_merge(bench.traffic(cell["traffic"]),
                               traffic_override), seed)
    device = torch.device(device)
    marks = [("start", time.perf_counter())]
    if system is None:
        from perfbench.system import System
        system = System(device)
    make = importlib.import_module(
        f"perfbench.inputs.{config['generator']}").make
    ref = importlib.import_module(f"perfbench.reference.{config['reference']}")
    marks.append(("system's import", time.perf_counter()))

    # -- set-up: the pool, the engine, one warm call per group of graphs --
    inputs = [make(config["graph"], plan.graph_seed(j), j)
              for j in range(plan.pool)]
    sizes = [input_bytes(x) for x in inputs]
    marks.append(("inputs", time.perf_counter()))
    graphs = [system.build(x) for x in inputs]
    system.sync()
    marks.append(("port's build", time.perf_counter()))
    engine = system.engine(config["engine"])
    warm = system.engine(config["engine"], max_rounds=loadgen.WARM_ROUNDS)
    for k, group in enumerate(plan.groups()):
        system.call(warm, plan.kind, [graphs[j] for j in group],
                    plan.warm_seed(k))
    system.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log(f"{workload}: set-up {setup_s:.3f} s (process start to run_cell "
        f"{marks[0][1] - t_start:.3f}" + "".join(
            f", {name} {t - marks[k][1]:.3f}"
            for k, (name, t) in enumerate(marks[1:])) +
        f"), pool of {plan.pool}, {plan.kind} of {plan.per_call}")

    # -- the window: whole calls back to back, the last one started
    #    before `seconds` --
    loops = (system.time_loops(engine)
             if trace and plan.kind == "run_many" else None)
    calls, kept, i, keep = [], [], 0, plan.sampler()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        n_loops = len(loops) if loops is not None else 0
        rec, answers = _one_call(system, engine, plan, graphs, sizes, i)
        if loops is not None:
            rec["loop_s"] = sum(loops[n_loops:])
        calls.append(rec)
        if keep(time.perf_counter() - start):
            # held on the host, so the card's memory and allocator see
            # only the port's own tensors
            kept.extend((j, logm.cpu(), b) for j, logm, b in answers)
        del answers
        i += 1
    window_s = time.perf_counter() - start
    dev = device_info(device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded in the run: {', '.join(found)}")
    log(f"{workload}: window {window_s:.3f} s, {len(calls)} calls")

    # -- the traced slice: a few more whole calls under the profiler --
    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from perfbench import trace as T
        # On the card only the device and the CUDA runtime are recorded:
        # recording every torch op as well slows the host's launches, and
        # raised the traced idle share of the host-bound Ising cell from
        # about 48 % to about 62 % in a trial on an H100.
        acts = [ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU]
        slice_calls = []
        with warnings.catch_warnings(), profile(activities=acts) as prof:
            warnings.simplefilter("ignore", UserWarning)
            t0 = time.perf_counter()
            while not slice_calls or \
                    time.perf_counter() - t0 < loadgen.TRACE_S:
                rec, _ = _one_call(system, engine, plan, graphs, sizes,
                                   i + len(slice_calls))
                slice_calls.append(rec)
            system.sync()
            slice_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        traced = T.summarize(prof)
        del prof
        traced.update(window_s=slice_s, calls=slice_calls)
        dev.update(busy_s=traced["busy_s"], window_s=slice_s)
        log(f"{workload}: traced {len(slice_calls)} calls in {slice_s:.3f} s"
            f", read in {time.perf_counter() - t0:.3f} s")

    # -- the check, once the program's state is freed --
    del engine, warm, graphs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs, readings = {}, {}
    for j, logm, beliefs in kept:
        if j not in refs:
            refs[j] = ref.Graph(inputs[j], device, torch.float64)
        for k, v in ref.judge(refs[j], logm, beliefs).items():
            readings.setdefault(k, []).append(v)
    del kept, refs
    if records is not None:
        records.append(dict(calls=calls, readings=readings))
    checks = {name: dict(value=_worst(readings.get(name, [])), limit=limit)
              for name, limit in config["limits"].items()}
    if device.type == "cuda" and system.launches():
        # the cell's kernel launched at least once a round in every call
        short = sum(sum(c["launches"].values()) < max(c["rounds"])
                    for c in calls)
        checks["calls_without_kernel"] = dict(value=short, limit=0)
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    log(f"{workload}: checked {sum(len(v) for v in readings.values())} "
        f"readings in {time.perf_counter() - t0:.3f} s")

    # -- the metrics, each from its own reader --
    ctx = dict(workload=workload, config=config, plan=plan, setup_s=setup_s,
               window=dict(wall_s=window_s, calls=calls), trace=traced,
               peaks=card_peaks(dev["kind"]))
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    graphs_done = [c for rec in calls for c in rec["converged"]]
    result = dict(correct=correct, attempted=len(graphs_done),
                  failed=graphs_done.count(False), metrics=metrics,
                  device=dev)
    if traced is not None:
        result["breakdown"] = dict(device_ops=traced["device_ops"],
                                   idle_gaps=traced["idle_gaps"])
    result["checks"] = checks
    return result
