"""The whole round's share of the fused update's bytes bound over the
window: the bytes every round of the window had to move over the real
edges of its call's graphs, at the card's peak rate, over the window's
wall. Rounds come from the answers, so it reads the same work whatever
implements it."""

from perfbench.roofline import round_work


def read(ctx):
    w, peaks = ctx["window"], ctx["peaks"]
    work = round_work(w["calls"])
    if not peaks or not work:
        return None
    return 100.0 * work / peaks["hbm_bytes_per_s"] / w["wall_s"]
