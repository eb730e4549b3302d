"""The control: the plain reference put in the system's place, computed in
the nearest precision below the one the configuration states.

It has ``System``'s interface, so the harness drives it through the same
set-up, window and check; a run of it must come out not correct. The
benchmark's own runs never use it: ``perfbench/calibrate.py`` and the
tests do.
"""

from __future__ import annotations

import importlib
import types

import torch

#: the configuration's precision -> the control's
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


class Control:
    """The reference module ``reference`` solving in ``LOWER[precision]``
    (its ``solve`` stands for the configuration's scheduler)."""

    def __init__(self, device, reference: str, precision: str):
        self.device = torch.device(device)
        self.ref = importlib.import_module(f"perfbench.reference.{reference}")
        self.dtype = LOWER[precision]

    def build(self, inputs: dict):
        return self.ref.Graph(inputs, self.device, self.dtype)

    def engine(self, engine_cfg: dict, **overrides):
        cfg = dict(engine_cfg, **overrides)
        if cfg["scheduler"] != "rnbp":
            raise ValueError("the control solves by randomized BP only")
        return cfg

    def call(self, engine, kind: str, graphs: list, seed: int) -> list:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(engine["scheduler_kwargs"])
        out = []
        for g in graphs:
            ans = self.ref.solve(g, eps=engine["eps"],
                                 max_rounds=engine["max_rounds"],
                                 low_p=kw["low_p"], high_p=kw["high_p"],
                                 generator=gen)
            out.append(types.SimpleNamespace(
                logm=ans["logm"], beliefs=ans["beliefs"],
                rounds=torch.tensor(ans["rounds"]),
                converged=torch.tensor(ans["converged"])))
        return out

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def launches(self) -> dict:
        return {}

