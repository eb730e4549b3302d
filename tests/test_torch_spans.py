"""The port's span recorder (``repro_torch.core.spans``) on the CPU: when it
records, the engine's span tree, call ids, the shared clock with
``torch.profiler``, and answers unchanged by recording."""

import dataclasses
import gc
import math
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import BPConfig, BPEngine, spans
from repro_torch.core.engine import SYNC_ROUNDS
from repro_torch.pgm import datasets as TD

RNBP = dict(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4, "high_p": 0.9})
ROUND_STAGES = {"bp.update", "bp.select", "bp.commit"}


def engine(backend="ref", **kw):
    return BPEngine(BPConfig(**dict(RNBP, backend=backend, **kw)),
                    device="cpu")


def graph(n=6, seed=0):
    return TD.ising_grid(n, 2.0, seed, device="cpu")


def gen(seed=3):
    return torch.Generator().manual_seed(seed)


def new_spans(fn):
    """``fn()``'s result and the spans recorded while it ran."""
    before = {r[0] for r in spans.spans()}
    out = fn()
    return out, [r for r in spans.spans() if r[0] not in before]


def profiled(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof


def by_id(rows):
    return {r[0]: r for r in rows}


def results_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name


def test_nothing_is_recorded_outside_a_profiler_or_start():
    eng = engine()
    _, rows = new_spans(lambda: eng.run(graph(), gen()))
    _, rows_many = new_spans(lambda: eng.run_many([graph(), graph(5)], 0))
    assert rows == [] and rows_many == []
    assert not spans.recording()


def test_an_off_site_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span site read the clock while off")
    monkeypatch.setattr(spans.time, "time_ns", no_clock)
    eng = engine("pallas", batch_backend="pallas")
    eng.run(graph(), gen())
    eng.run_many([graph(), graph(5, 1)], 0)


def test_start_and_stop_record_without_a_profiler():
    eng = engine()
    spans.start()
    try:
        assert spans.recording()
        _, rows = new_spans(lambda: eng.run(graph(), gen()))
    finally:
        spans.stop()
    assert not spans.recording()
    assert Counter(r[1] for r in rows)["bp.call"] == 1
    _, after = new_spans(lambda: eng.run(graph(), gen()))
    assert after == []
    # reading leaves the buffer as it was
    assert spans.spans()[-len(rows):] == rows


@pytest.mark.parametrize("n, seed, max_rounds", [
    (6, 0, 2000), (8, 1, 2000), (10, 2, 2000), (8, 1, 20)])
def test_run_gives_the_engine_tree(n, seed, max_rounds):
    eng = engine(max_rounds=max_rounds)
    (res, rows), _ = profiled(lambda: new_spans(
        lambda: eng.run(graph(n, seed), gen(seed))))
    ids = by_id(rows)
    name = lambda i: ids[i][1] if i in ids else None     # noqa: E731
    calls = [r for r in rows if r[1] == "bp.call"]
    assert len(calls) == 1 and calls[0][4] is None
    call = calls[0][6]
    assert call is not None and {r[6] for r in rows} == {call}
    assert {r[5] for r in rows} == {calls[0][5]}
    for r in rows:
        assert r[2] <= r[3]
        if r[4] is not None:
            p = ids[r[4]]
            assert p[2] <= r[2] and r[3] <= p[3]
    for r in rows:
        if r[1] in ("bp.step", "bp.init", "bp.result"):
            assert name(r[4]) == "bp.call"
        elif r[1] == "bp.round":
            assert name(r[4]) == "bp.step"
        elif r[1] in ROUND_STAGES:
            assert name(r[4]) == "bp.round"
    rounds = [r for r in rows if r[1] == "bp.round"]
    for rnd in rounds:
        kids = [name(c[0]) for c in rows if c[4] == rnd[0]]
        assert ROUND_STAGES <= set(kids) <= ROUND_STAGES | {"bp.sync"}
    r = int(res.rounds)
    want = min(SYNC_ROUNDS * math.ceil((r + 1) / SYNC_ROUNDS), max_rounds)
    assert len(rounds) == want


def test_run_many_adds_bucket_fold_and_split_under_one_call():
    eng = engine()
    pgms = [graph(6, 0), graph(6, 1), graph(6, 2)]
    (_, rows), _ = profiled(lambda: new_spans(lambda: eng.run_many(pgms, 7)))
    names = Counter(r[1] for r in rows)
    assert names["bp.call"] == 1
    assert {"bp.bucket", "bp.fold", "bp.split"} <= set(names)
    assert len({r[6] for r in rows}) == 1
    # the union is built once, by init, and kept
    ids = by_id(rows)
    (fold,) = [r for r in rows if r[1] == "bp.fold"]
    assert ids[fold[4]][1] == "bp.init"
    assert ids[ids[fold[4]][4]][1] == "bp.call"


@pytest.mark.parametrize("backend, inner", [
    ("triton", {"bp.prelude"}), ("pallas", {"bp.prelude", "bp.transpose"})])
def test_kernel_backends_mark_prelude_and_copies(backend, inner):
    eng = engine(backend)
    (_, rows), _ = profiled(lambda: new_spans(
        lambda: eng.run(graph(), gen())))
    ids = by_id(rows)
    found = Counter(r[1] for r in rows if r[4] is not None
                    and ids[r[4]][1] == "bp.update")
    # "pallas" builds the graph's transposed tables in its first update
    assert found.pop("bp.fold", 0) == (backend == "pallas")
    assert set(found) == inner
    n_update = sum(r[1] == "bp.update" for r in rows)
    n_transpose = sum(r[1] == "bp.transpose" for r in rows)
    assert n_transpose == (2 * n_update if backend == "pallas" else 0)


@pytest.mark.parametrize("many", [False, True])
def test_answers_with_recording_are_bitwise_those_without(many):
    eng = engine("pallas", batch_backend="pallas")
    pgms = [graph(6, 0), graph(6, 1)]
    call = ((lambda: eng.run_many(pgms, 5)) if many else
            (lambda: [eng.run(pgms[0], gen(5))]))
    off = call()
    on, _ = profiled(call)
    spans.start()
    try:
        started = call()
    finally:
        spans.stop()
    for a, b, c in zip(off, on, started):
        results_equal(a, b)
        results_equal(a, c)


def test_aten_ops_of_the_loop_lie_inside_port_spans():
    """On the shared clock the profiler's ops fall in the loop, and at
    least 99 % of those between the first round's start and the last
    round's end lie inside a ``bp.round`` (the rest would be within the
    profiler's clock conversion of one: none were in trials)."""
    eng = engine()
    (_, rows), prof = profiled(lambda: new_spans(
        lambda: eng.run(graph(8, 1), gen(1))))
    ops = [(e.start_ns(), e.end_ns()) for e in
           prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    rounds = sorted((r[2], r[3]) for r in rows if r[1] == "bp.round")
    lo, hi = rounds[0][0], rounds[-1][1]
    loop = [op for op in ops if lo <= op[0] <= hi]
    assert len(loop) > 20 * len(rounds)
    inside = sum(any(s <= a and b <= e for s, e in rounds) for a, b in loop)
    assert inside >= 0.99 * len(loop), (inside, len(loop))
    # the span tree's wall agrees with the host clock's
    call = next(r for r in rows if r[1] == "bp.call")
    assert abs(call[2] - time.time_ns()) < 60e9


def test_a_call_inside_a_call_is_part_of_it():
    eng = engine()

    def nested():
        return eng.run_many([graph()], 0), eng.run(graph(), gen())
    spans.start()
    try:
        rec = spans.begin("bp.call", call=True)
        _, rows = new_spans(nested)
        spans.end(rec)
    finally:
        spans.stop()
    assert not any(r[1] == "bp.call" for r in rows)
    assert {r[6] for r in rows} == {rec[5]}


def test_serving_chunks_carry_spans_without_a_call():
    eng = engine(chunk_rounds=8)
    spans.start()
    try:
        _, rows = new_spans(lambda: eng.serve([graph(5, 0), graph(5, 1)], 0,
                                              max_batch=2))
    finally:
        spans.stop()
    names = Counter(r[1] for r in rows)
    assert names["bp.step"] >= 2 and names["bp.round"] >= 8
    assert names["bp.call"] == 0 and {r[6] for r in rows} == {None}


def test_the_buffer_keeps_the_newest_untracked_by_the_collector():
    assert spans.CAPACITY == 1 << 20
    assert spans._buffer.maxlen == len(spans.FIELDS) * spans.CAPACITY
    assert spans.FIELDS == ("id", "name", "start_ns", "end_ns", "parent",
                            "thread", "call")
    eng = engine()
    spans.start()
    try:
        _, rows = new_spans(lambda: eng.run(graph(), gen()))
    finally:
        spans.stop()
    assert rows and not any(map(gc.is_tracked, spans._buffer))
