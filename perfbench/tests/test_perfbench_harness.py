"""Whole runs of each cell on the CPU at small sizes, through the plain
path: the result's schema, the control and planted faults coming out not
correct, and the entry point refusing to run without a card."""

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, loadgen
from perfbench.control import Control
from perfbench.system import System

SMALL = {"ising1000": {"graph": {"n": 12}},
         "stereo_tsukuba": {"graph": {"height": 10, "width": 12,
                                      "n_disp": 6}}}
FAST = {"check_period_s": 0.02}
CELLS = [w["name"] for w in harness.Bench().doc["workloads"]]


@pytest.fixture(autouse=True)
def short_trace(monkeypatch):
    monkeypatch.setattr(loadgen, "TRACE_S", 0.05)


def run(cell, seed=2 ** 31 + 5, trace=False, system=None, seconds=0.3):
    config = harness.Bench().cell(cell)["config"]
    return harness.run_cell(cell, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            system=system, config_override=SMALL[config],
                            traffic_override=FAST)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_schema(cell, trace):
    res = run(cell, trace=bool(trace))
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = harness.Bench().doc
    group = bench["per_layer" if trace else "end_to_end"]
    units = {m["name"]: m["unit"] for m in group}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "graphs_per_s" in res["metrics"]
        assert "setup_s" in res["metrics"]
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(res))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", ["ising1000.solo", "stereo_tsukuba.solo"])
def test_control_is_not_correct(cell, seed):
    """The reference in bfloat16, in the port's place, fails the check."""
    config = harness.Bench().config(harness.Bench().cell(cell)["config"])
    ctl = Control("cpu", config["reference"], config["precision"])
    res = run(cell, seed=seed, system=ctl)
    assert res["correct"] is False
    assert any(c["value"] > 3 * c["limit"] for c in res["checks"].values())


class Unchanged(System):
    """The update hands back the messages it was given, residual 0."""

    def engine(self, cfg, **kw):
        eng = super().engine(cfg, **kw)
        same = lambda g, logm: (logm, torch.zeros(logm.shape[:-1]))  # noqa
        eng.update_fn = eng.batch_update_fn = same
        return eng


class HalfBucket(System):
    """The bucket's update leaves out its second half of graphs."""

    def engine(self, cfg, **kw):
        eng = super().engine(cfg, **kw)
        full = eng.batch_update_fn

        def half(batch, logm):
            cand, resid = full(batch, logm)
            h = batch.size // 2
            cand = torch.cat([cand[:h], logm[h:]])
            return cand, torch.cat([resid[:h], torch.zeros_like(resid[h:])])
        eng.batch_update_fn = half
        return eng


class Altered(System):
    """One marginal of every answer is altered where it is produced."""

    def engine(self, cfg, **kw):
        eng = super().engine(cfg, **kw)
        result = eng.result

        def bent(state):
            res = result(state)
            b = res.beliefs.clone()
            row = b[..., 1, :]
            row.copy_(torch.log_softmax(row + torch.arange(
                row.shape[-1], dtype=row.dtype), dim=-1))
            return dataclasses.replace(res, beliefs=b)
        eng.result = bent
        return eng


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in (Unchanged, HalfBucket, Altered)
    if f is not HalfBucket or c.endswith("batch4")])
def test_planted_fault_is_not_correct(cell, fault):
    res = run(cell, system=fault(torch.device("cpu")))
    assert res["correct"] is False


def test_entry_point_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "ising1000.solo", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    res = harness.run_cell("stereo_tsukuba.solo", 11, 2.0, True,
                           t_start=time.perf_counter(), device="cuda",
                           config_override=SMALL["stereo_tsukuba"],
                           traffic_override=FAST)
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert res["checks"]["calls_without_kernel"]["value"] == 0
