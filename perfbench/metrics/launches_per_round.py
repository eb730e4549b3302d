"""Device kernels in the traced slice over the rounds its calls ran."""

from perfbench.roofline import rounds_run


def read(ctx):
    t = ctx["trace"]
    n = rounds_run(t["calls"]) if t else 0
    return t["n_kernels"] / n if n else None
