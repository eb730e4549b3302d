"""Mean ``BPResult.rounds`` over the window's graphs (the scheduler's
count of committing rounds)."""


def read(ctx):
    rounds = [r for c in ctx["window"]["calls"] for r in c["rounds"]]
    return sum(rounds) / len(rounds) if rounds else None
