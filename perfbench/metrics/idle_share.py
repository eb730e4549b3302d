"""Percent of the traced slice's wall in which no operation ran on the
device: one minus the union of the device intervals over the slice."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
