"""95th percentile of every call's latency in the window, from the call to
its return with the answer on the host; none under 20 calls."""

import statistics


def read(ctx):
    walls = [c["wall_s"] for c in ctx["window"]["calls"]]
    if len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94] * 1e3
