"""Window wall over the rounds its calls ran (a bucket's round counts
once: each call's most ``BPResult.rounds``)."""

from perfbench.roofline import rounds_run


def read(ctx):
    w = ctx["window"]
    n = rounds_run(w["calls"])
    return w["wall_s"] * 1e3 / n if n else None
