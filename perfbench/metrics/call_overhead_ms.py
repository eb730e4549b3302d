"""Host time a call spends around its rounds, a traced call's mean, from
the port's spans: ``bp.init``, ``bp.result`` and each ``bp.step``'s own
time outside its ``bp.round``s (the chunk start's reads included), less
the ``bp.fold`` inside them (a bucket's union, built in ``init``), which
``fold_host_ms`` reads."""

from perfbench import spans


def read(ctx):
    calls = spans.slice_calls(ctx)
    if not calls:
        return None
    total = sum(spans.own_seconds(c, "bp.init", ("bp.fold",)) +
                spans.own_seconds(c, "bp.result", ("bp.fold",)) +
                spans.own_seconds(c, "bp.step", ("bp.round", "bp.fold"))
                for c in calls)
    return total * 1e3 / len(calls)
