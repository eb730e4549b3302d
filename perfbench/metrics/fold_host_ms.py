"""Host time a ``run_many`` call spends bucketing, folding and splitting,
a traced call's mean, from the port's spans: ``bp.bucket``, ``bp.fold``
and ``bp.split``, each counted once, with no sync added; none where the
slice's calls made no bucket."""

from perfbench import spans

FOLD = ("bp.bucket", "bp.fold", "bp.split")


def read(ctx):
    calls = spans.slice_calls(ctx)
    if not calls or not any(spans.named(c, "bp.bucket") for c in calls):
        return None
    return sum(spans.seconds(spans.outermost(c, FOLD))
               for c in calls) * 1e3 / len(calls)
