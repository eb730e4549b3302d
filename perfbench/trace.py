"""Reduction of a ``torch.profiler`` trace of the profiled slice.

Reads the raw events of the trace (``kineto_results``): every device
operation (kernels, copies, memsets) with its interval, and every host
event recorded (the CUDA runtime's calls; torch ops too where the
profiler records them). From them:

- ``busy_s``: the union of the device intervals, so work that overlaps on
  two streams counts once;
- per kernel name, its launches and device seconds (copies and memsets
  are not kernels);
- the idle gaps between device intervals, each named by the innermost
  host operation running at its middle, or ``(no host op)`` where the
  host was in Python between operations.
"""

from __future__ import annotations

import numpy as np

#: device activities that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")
#: the longest gaps that are named (each is looked up among host ops)
NAMED_GAPS = 2000


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    """``busy_s``, ``n_kernels``, ``kernels`` ({name: [launches,
    seconds]}), ``device_ops`` and ``idle_gaps`` (each the ten largest
    ``[name, seconds]``) of a finished profile."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.start_ns(), ev.end_ns(), ev.name())
        if ev.device_type() == DeviceType.CUDA:
            dev.append(span)
        elif ev.device_type() == DeviceType.CPU:
            host.append(span)
    kernels, ops = {}, {}
    for a, b, name in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
        if not name.startswith(NOT_KERNELS):
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e9
    merged = _merged([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in merged) / 1e9
    gaps = sorted(((merged[k + 1][0] - merged[k][1], merged[k][1],
                    merged[k + 1][0]) for k in range(len(merged) - 1)),
                  reverse=True)[:NAMED_GAPS]
    idle = {}
    if gaps and host:
        starts = np.array([a for a, _, _ in host], dtype=np.int64)
        ends = np.array([b for _, b, _ in host], dtype=np.int64)
        for length, a, b in gaps:
            mid = (a + b) // 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = ("(no host op)" if inside.size == 0 else
                    host[inside[np.argmax(starts[inside])]][2])
            idle[name] = idle.get(name, 0.0) + length / 1e9
    top = lambda d: [[k[:160], v] for k, v in sorted(      # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_s, n_kernels=sum(k[0] for k in kernels.values()),
                kernels=kernels, device_ops=top(ops), idle_gaps=top(idle))
