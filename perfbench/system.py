"""The system under test: the PyTorch and CUDA port, ``repro_torch``.

The only module of the benchmark that imports the port. It hands the
port the raw inputs through its public graph builder, builds its engine
from the configuration's ``engine`` section, makes one call of a traffic
mix's kind, and reads the kernels' launch counters. Nothing of the port
is imported before ``System`` is made, so the harness can look for the
card first.
"""

from __future__ import annotations

import time

import torch


class System:
    """The port on ``device``: ``build`` a pool graph, ``engine`` one
    ``BPEngine`` per ``max_rounds``, ``call`` one traffic call,
    ``launches`` the kernels' launch counts so far."""

    def __init__(self, device):
        from repro_torch.core import BPConfig, BPEngine, build_pgm_uniform
        from repro_torch.kernels import message_update, triton_update
        self.device = torch.device(device)
        self._config, self._engine = BPConfig, BPEngine
        self._build = build_pgm_uniform
        self._counters = (triton_update.LAUNCHES, message_update.LAUNCHES)

    def build(self, inputs: dict):
        return self._build(inputs["n_vertices"], inputs["edges"],
                           inputs["unary"], inputs["pairwise"],
                           device=self.device)

    def engine(self, engine_cfg: dict, **overrides):
        cfg = dict(engine_cfg, **overrides)
        return self._engine(self._config(**cfg), device=self.device)

    def call(self, engine, kind: str, graphs: list, seed: int) -> list:
        """One call: ``run`` on one graph with a fresh generator seeded
        ``seed``, or ``run_many`` on a list with base seed ``seed``.
        Returns one ``BPResult`` per graph."""
        if kind == "run":
            (graph,) = graphs
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return [engine.run(graph, gen)]
        if kind == "run_many":
            return engine.run_many(graphs, seed)
        raise ValueError(f"unknown call kind {kind!r}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def launches(self) -> dict:
        """Kernel launches so far, by kernel (the CPU's plain path counts
        none)."""
        e, t = self._counters
        return {"fused_update_e": e["sum"] + e["max"],
                "fused_update_t": t["sum"]}

    def time_loops(self, engine) -> list:
        """Shadow ``engine.run`` -- one call per bucket under ``run_many``
        -- so that each appends its seconds, the card synchronized at both
        ends, to the returned list. For traced runs only: the syncs cost
        the window time."""
        run, loops = engine.run, []

        def timed(graph, rng=None, **kw):
            self.sync()
            t0 = time.perf_counter()
            res = run(graph, rng, **kw)
            self.sync()
            loops.append(time.perf_counter() - t0)
            return res

        engine.run = timed
        return loops
