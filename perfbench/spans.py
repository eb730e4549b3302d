"""Reading the port's own spans (``repro_torch.core.spans``) in a traced run.

The port records a span for each stage of a ``BPEngine`` call while a
torch profiler is active, on the profiler's clock. The readers here find
the recorder through ``sys.modules`` (``perfbench/system.py`` stays the
only module of the benchmark that imports the port), and read the trees of
the traced slice's calls only: the last ``len(ctx["trace"]["calls"])``
calls the recorder holds, so spans of any earlier profile in the process
count for nothing. Each returns None where the port records no spans (as
before they existed) or the slice has none to read.

``by_span`` names the slice's idle gaps and device seconds by port span
(``python3 perfbench/spans.py --help``).
"""

from __future__ import annotations

import sys

RECORDER = "repro_torch.core.spans"
#: spans whose time is the host waiting on the device, or building a
#: bucket's union, rather than running a round
NOT_ROUND_WORK = ("bp.sync", "bp.fold")


def slice_calls(ctx) -> list | None:
    """One list of span tuples (``(id, name, start_ns, end_ns, parent,
    thread, call)``) per call of the traced slice, oldest first; None
    without a trace, a recorder, or a span tree for every call."""
    rec, trace = sys.modules.get(RECORDER), ctx.get("trace")
    if rec is None or not trace or not trace["calls"]:
        return None
    rows = rec.spans()
    ids = sorted({r[6] for r in rows if r[1] == "bp.call"})
    n = len(trace["calls"])
    if len(ids) < n:
        return None
    want = {c: k for k, c in enumerate(ids[-n:])}
    out = [[] for _ in range(n)]
    for r in rows:
        if r[6] in want:
            out[want[r[6]]].append(r)
    return out


def seconds(rows) -> float:
    """Summed durations of ``rows``, in seconds."""
    return sum(r[3] - r[2] for r in rows) / 1e9


def outermost(rows, names) -> list:
    """The spans of ``rows`` named in ``names`` that lie inside no other
    such span, so nested ones count once."""
    by_id = {r[0]: r for r in rows}
    out = []
    for r in rows:
        if r[1] not in names:
            continue
        p = by_id.get(r[4])
        while p is not None and p[1] not in names:
            p = by_id.get(p[4])
        if p is None:
            out.append(r)
    return out


def own_seconds(rows, name: str, minus) -> float:
    """Time in the spans called ``name``, less the outermost spans named in
    ``minus`` that lie inside them."""
    by_id = {r[0]: r for r in rows}

    def under(r):
        p = by_id.get(r[4])
        while p is not None and p[1] != name:
            p = by_id.get(p[4])
        return p is not None
    inner = [r for r in outermost(rows, set(minus)) if under(r)]
    return seconds([r for r in rows if r[1] == name]) - seconds(inner)


def named(rows, *names) -> list:
    return [r for r in rows if r[1] in names]


# -- the slice's idle gaps and kernels by port span --------------------------

def by_span(events, rows) -> dict:
    """From a CUDA profile's raw events (``(kind, name, start_ns, end_ns,
    correlation)``, ``kind`` ``"device"`` or ``"host"``) and the port's
    spans over the same period: ``idle`` ({span name: seconds}, each idle
    gap between device intervals put down to the innermost span on the
    launching thread open at its middle; where none is, to ``outside the
    port:`` and the innermost host event there, as ``perfbench/trace.py``
    names gaps) and ``device`` ({span name: seconds}, each device operation
    put down to the innermost span open when the host call that launched
    it -- matched by kineto's correlation id -- began) and ``idle_ops``
    (the idle seconds by span and the innermost host event at each gap's
    middle, ``"<span> / <event>"``)."""
    import numpy as np
    dev = sorted((a, b, c) for k, _, a, b, c in events if k == "device")
    launch = {c: a for k, _, a, _, c in events if k == "host" and c}
    if not dev or not rows:
        return dict(idle={}, device={}, idle_ops={})
    thread = max({r[5] for r in rows},
                 key=lambda t: sum(r[1] == "bp.round" and r[5] == t
                                   for r in rows))
    mine = sorted((r for r in rows if r[5] == thread), key=lambda r: r[2])
    starts = np.array([r[2] for r in mine], dtype=np.int64)
    ends = np.array([r[3] for r in mine], dtype=np.int64)

    host = sorted((a, b, n) for k, n, a, b, _ in events if k == "host")
    h_starts = np.array([a for a, _, _ in host], dtype=np.int64)
    h_ends = np.array([b for _, b, _ in host], dtype=np.int64)

    def host_op(t):
        inside = np.flatnonzero((h_starts <= t) & (h_ends >= t))
        return (host[inside[np.argmax(h_starts[inside])]][2] if inside.size
                else "(no host op)")

    def innermost(t):
        inside = np.flatnonzero((starts <= t) & (ends >= t))
        if inside.size:
            return mine[inside[np.argmax(starts[inside])]][1]
        return "outside the port: " + host_op(t)
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle, device, idle_ops = {}, {}, {}
    for (_, b), (a, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        k = innermost(mid)
        idle[k] = idle.get(k, 0.0) + (a - b) / 1e9
        k = f"{k} / {host_op(mid)}"
        idle_ops[k] = idle_ops.get(k, 0.0) + (a - b) / 1e9
    for a, b, c in dev:
        k = innermost(launch[c]) if c in launch else "(no launch seen)"
        device[k] = device.get(k, 0.0) + (b - a) / 1e9
    return dict(idle=idle, device=device, idle_ops=idle_ops)


def self_seconds(rows) -> dict:
    """{span name: seconds}: each span's time less its children's."""
    out, kids = {}, {}
    for r in rows:
        if r[4] is not None:
            kids[r[4]] = kids.get(r[4], 0) + r[3] - r[2]
    for r in rows:
        own = r[3] - r[2] - kids.get(r[0], 0)
        out[r[1]] = out.get(r[1], 0.0) + own / 1e9
    return out


def kineto_events(prof) -> list:
    """``by_span``'s events of a finished ``torch.profiler`` profile."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = ("device" if ev.device_type() == DeviceType.CUDA else
                "host" if ev.device_type() == DeviceType.CPU else None)
        if kind:
            out.append((kind, ev.name(), ev.start_ns(), ev.end_ns(),
                        ev.correlation_id()))
    return out


def main(argv=None) -> int:
    """One traced run of a cell, as ``perfbench/run.py --trace 1`` makes
    it, printing the result and, for the traced slice, its idle seconds
    and device seconds by port span (``by_span``) and its calls' host
    seconds by span (``self_seconds``), as one JSON object."""
    import argparse
    import json
    import time
    from pathlib import Path
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    ap = argparse.ArgumentParser(description=main.__doc__.split(".")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    from perfbench import harness, trace
    kept, summarize = {}, trace.summarize

    def keep(prof):                  # the process records only the slice
        rows = sys.modules[RECORDER].spans()
        kept.update(by_span(kineto_events(prof), rows),
                    host=self_seconds(rows))
        return summarize(prof)
    trace.summarize = keep
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              t_start=t_start, device=args.device)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa: E731
    print(json.dumps(dict(
        result=result, idle_by_span=top(kept["idle"]),
        idle_by_span_and_op=top(kept["idle_ops"])[:12],
        device_by_span=top(kept["device"]),
        host_self_by_span=top(kept["host"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
