"""Host time a round in the traced slice, from the port's spans: the
time inside ``bp.round`` less its ``bp.sync`` (waiting on the device) and
``bp.fold`` (a bucket's union, built in round 0), over the rounds the
slice's answers report."""

from perfbench import spans
from perfbench.roofline import rounds_run


def read(ctx):
    calls = spans.slice_calls(ctx)
    n = rounds_run(ctx["trace"]["calls"]) if calls else 0
    if not n:
        return None
    host = sum(spans.own_seconds(c, "bp.round", spans.NOT_ROUND_WORK)
               for c in calls)
    return host * 1e3 / n
