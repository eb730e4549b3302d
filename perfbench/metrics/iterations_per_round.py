"""Loop iterations (``bp.round`` spans) in the traced slice over the
rounds its answers report: above 1 by the inert iterations a call runs
to the end of its ``done`` read's window of 16."""

from perfbench import spans
from perfbench.roofline import rounds_run


def read(ctx):
    calls = spans.slice_calls(ctx)
    n = rounds_run(ctx["trace"]["calls"]) if calls else 0
    if not n:
        return None
    return sum(len(spans.named(c, "bp.round")) for c in calls) / n
