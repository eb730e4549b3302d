"""``run_many``'s wall minus its engine loops' walls, a call's mean: the
bucketing, the fold and the per-graph results around the loop."""


def read(ctx):
    out = [c["wall_s"] - c["loop_s"] for c in ctx["window"]["calls"]
           if "loop_s" in c]
    return sum(out) / len(out) * 1e3 if out else None
