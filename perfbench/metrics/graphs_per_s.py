"""Graphs that converged within ``max_rounds``, over the whole window."""


def read(ctx):
    w = ctx["window"]
    return sum(sum(c["converged"]) for c in w["calls"]) / w["wall_s"]
