"""The harness is driven by data: ``BENCHMARK.json`` keeps to its
contract, and a new configuration, traffic mix and per-layer metric are
new files and entries only."""

import json
import math
import re
import shutil
import subprocess
import sys

from perfbench import harness

DOC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_the_contract():
    assert list(DOC) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert DOC["paths"] == ["perfbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    rs = DOC["run_seconds"]
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in DOC["configs"]]
    cells = [w["name"] for w in DOC["workloads"]]
    metrics = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "name"] == c["name"]
        assert c["name"] in {w["config"] for w in DOC["workloads"]}
    pairs = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(DOC["workloads"])
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    assert "workloads" not in next(m for m in DOC["end_to_end"]
                                   if m["name"] == "setup_s")
    for m in DOC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
        assert m["source"] in SOURCES
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:       # every cell: setup_s, another, a layer metric
        e2e = harness.Bench().metrics(cell, False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.Bench().metrics(cell, True)
    assert len(json.dumps(DOC)) < 64 * 1024


NEW_CONFIG = {
    "name": "ising_tiny", "source": "https://arxiv.org/abs/1909.11469",
    "generator": "ising_grid",
    "graph": {"n": 6, "coupling": 2.0, "unary_low": 0.001, "unary_high": 1.0,
              "lambda_low": -0.5, "lambda_high": 0.5},
    "engine": {"scheduler": "lbp", "eps": 0.001, "max_rounds": 500,
               "backend": "ref"},
    "precision": "float32", "reference": "pairwise_bp",
    "limits": {"fixed_point_resid": 0.0015, "belief_gap": 1e-05}}
NEW_TRAFFIC = {"why": "two graphs a call", "call": "run_many", "pool": 2,
               "graphs_per_call": 2, "check_period_s": 0.05}
NEW_METRIC = '''"""Graphs a call in the window."""


def read(ctx):
    calls = ctx["window"]["calls"]
    return sum(len(c["graphs"]) for c in calls) / len(calls)
'''


def test_new_config_traffic_and_metric_are_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a mix and a
    per-layer metric as new files plus new entries in BENCHMARK.json; its
    harness, untouched, runs the new cell and reads the new metric."""
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = json.loads(json.dumps(DOC))
    doc["configs"].append(dict(name="ising_tiny", source=NEW_CONFIG["source"],
                               file="perfbench/configs/ising_tiny.json",
                               reduced=["n"], why="a 6 x 6 grid"))
    doc["workloads"].append(dict(name="ising_tiny.pair", config="ising_tiny",
                                 traffic="pair", chips=1, why="two a call"))
    doc["per_layer"].append(dict(
        name="graphs_per_call", unit="graphs", better="higher",
        source="program_counter", layer="batched fold", moves="graphs_per_s",
        workloads=["ising_tiny.pair"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    pb = tmp_path / "perfbench"
    (pb / "configs" / "ising_tiny.json").write_text(json.dumps(NEW_CONFIG))
    (pb / "traffic" / "pair.json").write_text(json.dumps(NEW_TRAFFIC))
    (pb / "metrics" / "graphs_per_call.py").write_text(NEW_METRIC)
    for f in harness.HERE.rglob("*.py"):
        rel = f.relative_to(harness.HERE)
        if rel.parts[0] not in ("tests",) and "__pycache__" not in rel.parts:
            assert (pb / rel).read_bytes() == f.read_bytes()
    code = ("import json, sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]"
            "; from perfbench import harness, loadgen\n"
            "loadgen.TRACE_S = 0.05\n"
            "assert harness.HERE.parent.samefile(sys.argv[1])\n"
            "for t in (0, 1): print(json.dumps(harness.run_cell("
            "'ising_tiny.pair', 9, 0.3, bool(t), t_start=time.perf_counter(),"
            " device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(harness.ROOT / "src")], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = map(json.loads, out.stdout.strip().splitlines())
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"graphs_per_s", "setup_s"}
    assert traced["metrics"]["graphs_per_call"]["value"] == 2.0
    assert math.isfinite(untraced["metrics"]["graphs_per_s"]["value"])
