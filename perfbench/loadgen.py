"""The one general load generator: a traffic mix's data file, read into
the calls of a closed loop.

A mix (``perfbench/traffic/<name>.json``) sets:

- ``call``: ``"run"`` (one graph a call, ``BPEngine.run``) or
  ``"run_many"`` (a list a call, ``BPEngine.run_many``);
- ``pool``: graphs built in set-up from the seed, cycled through by the
  window; ``graphs_per_call``: how many of them one call takes;
- ``check_period_s``: the answers of the call that runs at each multiple
  of this many seconds into the window, shifted by a fraction of it drawn
  from the seed, are kept and held against the reference.

Every mix warms up with one call of ``WARM_ROUNDS`` rounds for each
distinct group of graphs its calls take, and a traced run profiles whole
calls, one after another, until ``TRACE_S`` seconds have passed. The
caller waits for each call to return before it sends the next. Every
number a run draws comes from ``--seed``: the pool's graphs (with a
configuration's ``catalog``, the symmetry each is seen under), each
call's generator seed and the sampling phase.
"""

from __future__ import annotations

import numpy as np

#: round limit of a warm-up call
WARM_ROUNDS = 32
#: seconds of whole calls run under the profiler in a traced run
TRACE_S = 1.0
#: ``derive`` streams: graph of the pool, seed of a call, sampling phase,
#: seed of a warm-up call
GRAPH, CALL, SAMPLE, WARM = 0, 1, 2, 3


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed from ``seed`` (any whole number) and a stream path."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Plan:
    """The calls of one run of a mix under ``seed``."""

    def __init__(self, params: dict, seed: int):
        self.kind = params["call"]
        self.pool = int(params["pool"])
        self.per_call = int(params["graphs_per_call"])
        self.check_period_s = float(params["check_period_s"])
        if not 1 <= self.per_call <= self.pool:
            raise ValueError("graphs_per_call must lie in [1, pool]")
        if self.kind == "run" and self.per_call != 1:
            raise ValueError("a 'run' call takes one graph")
        self.seed = int(seed)
        self.check_phase = derive(seed, SAMPLE) / 2.0 ** 63

    def graph_seed(self, j: int) -> int:
        """Seed of the pool's graph ``j``."""
        return derive(self.seed, GRAPH, j)

    def graphs(self, i: int) -> tuple:
        """Pool indices of call ``i``'s graphs."""
        first = i * self.per_call
        return tuple((first + k) % self.pool for k in range(self.per_call))

    def call_seed(self, i: int) -> int:
        """Seed of call ``i``'s generator (the base seed of a list)."""
        return derive(self.seed, CALL, i)

    def warm_seed(self, i: int) -> int:
        return derive(self.seed, WARM, i)

    def groups(self) -> list:
        """Each distinct group of graphs that the calls take, once."""
        seen = []
        for i in range(self.pool):
            g = self.graphs(i)
            if g not in seen:
                seen.append(g)
        return seen

    def sampler(self):
        """``keep(t)``: whether the call that ends ``t`` seconds into the
        window is held against the reference (it ran at a sampling
        instant); call it once a call, in order."""
        due = [self.check_phase * self.check_period_s]

        def keep(t: float) -> bool:
            if t < due[0]:
                return False
            while due[0] <= t:
                due[0] += self.check_period_s
            return True
        return keep
