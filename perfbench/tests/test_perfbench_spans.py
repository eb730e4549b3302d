"""The per-layer metrics that read the port's spans: reported, finite, in a
traced CPU run of each cell that lists them, absent from an untraced run,
and blind to spans of calls outside the traced slice."""

import math
import sys
import time
import types

import pytest

from perfbench import harness, loadgen
from perfbench import spans as S

SMALL = {"ising1000": {"graph": {"n": 12}},
         "stereo_tsukuba": {"graph": {"height": 10, "width": 12,
                                      "n_disp": 6}}}
SPAN_METRICS = ("host_ms_per_round", "iterations_per_round",
                "call_overhead_ms", "fold_host_ms")
CELLS = [w["name"] for w in harness.Bench().doc["workloads"]]


@pytest.fixture(autouse=True)
def short_trace(monkeypatch):
    monkeypatch.setattr(loadgen, "TRACE_S", 0.05)


def run(cell, trace, seed=2 ** 31 + 9):
    config = harness.Bench().cell(cell)["config"]
    return harness.run_cell(cell, seed, 0.2, trace,
                            t_start=time.perf_counter(), device="cpu",
                            config_override=SMALL[config],
                            traffic_override={"check_period_s": 0.02})


def listed(cell):
    return {m["name"] for m in harness.Bench().metrics(cell, True)
            if m["name"] in SPAN_METRICS}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_metrics(cell):
    res = run(cell, True)
    assert res["correct"] is True
    want = listed(cell)
    assert {"host_ms_per_round", "iterations_per_round",
            "call_overhead_ms"} <= want
    assert ("fold_host_ms" in want) == cell.endswith("batch4")
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in want:
        assert math.isfinite(got[name]) and got[name] > 0, name
    assert got["iterations_per_round"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_an_untraced_run_reports_none(cell):
    res = run(cell, False)
    assert not set(res["metrics"]) & set(SPAN_METRICS)


def row(i, name, a, b, parent, call):
    return (i, name, a, b, parent, 1, call)


def fake_call(call, first_id, t0, n_rounds, ms):
    """A call's span tree: init, a step of ``n_rounds`` rounds of ``ms``
    each with a 1 ms sync inside, result."""
    c, st, ns = first_id, first_id + 1, 1_000_000
    rows = [row(c + 2, "bp.init", t0, t0 + ns, c, call)]
    t = t0 + ns
    step_start, k = t, c + 3
    t += ns                                # the step's own set-up
    for _ in range(n_rounds):
        rows.append(row(k, "bp.round", t, t + ms * ns, st, call))
        rows.append(row(k + 1, "bp.sync", t, t + ns, k, call))
        t, k = t + ms * ns, k + 2
    rows.append(row(st, "bp.step", step_start, t, c, call))
    rows.append(row(k, "bp.result", t, t + ns, c, call))
    rows.append(row(c, "bp.call", t0, t + ns, None, call))
    return rows


def test_spans_of_earlier_calls_count_for_nothing(monkeypatch):
    """Spans of an earlier profile stay in the recorder; the readers take
    the last calls, as many as the slice ran."""
    old = fake_call(1, 0, 0, 50, 9) + fake_call(2, 1000, 10 ** 9, 50, 9)
    new = fake_call(3, 2000, 2 * 10 ** 9, 32, 3)
    recorder = types.SimpleNamespace(spans=lambda: old + new)
    monkeypatch.setitem(sys.modules, S.RECORDER, recorder)
    ctx = dict(trace=dict(calls=[dict(rounds=[30])]))
    read = lambda name: harness.reader(name)(ctx)        # noqa: E731
    assert read("iterations_per_round") == pytest.approx(32 / 30)
    assert read("host_ms_per_round") == pytest.approx(32 * 2 / 30)
    assert read("call_overhead_ms") == pytest.approx(3.0)
    assert read("fold_host_ms") is None
    # the same, the earlier calls gone
    recorder.spans = lambda: new
    assert read("host_ms_per_round") == pytest.approx(32 * 2 / 30)
    # fewer call trees than calls, or no recorder: nothing to read
    ctx["trace"]["calls"] *= 4
    assert read("iterations_per_round") is None
    monkeypatch.delitem(sys.modules, S.RECORDER)
    ctx["trace"]["calls"] = [dict(rounds=[30])]
    assert read("iterations_per_round") is None


def test_by_span_names_gaps_and_kernels():
    rows = [row(0, "bp.round", 0, 100, None, 1),
            row(1, "bp.update", 10, 40, 0, 1),
            row(2, "bp.sync", 60, 90, 0, 1)]
    events = [("host", "cudaLaunchKernel", 12, 14, 7),
              ("host", "cudaLaunchKernel", 45, 47, 8),
              ("device", "k1", 20, 50, 7),
              ("device", "k2", 80, 95, 8),
              ("host", "cudaMemcpyAsync", 120, 200, 9),
              ("device", "copy", 210, 220, 9)]
    out = S.by_span(events, rows)
    assert out["device"] == {"bp.update": 30e-9, "bp.round": 15e-9,
                             "outside the port: cudaMemcpyAsync": 10e-9}
    assert out["idle"] == {"bp.sync": 30e-9,
                           "outside the port: cudaMemcpyAsync": 115e-9}
    assert S.self_seconds(rows) == pytest.approx(
        {"bp.round": 40e-9, "bp.update": 30e-9, "bp.sync": 30e-9})
