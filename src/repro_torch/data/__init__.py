"""Synthetic LM data (a port of ``repro.data``): ``SyntheticLM`` batches
as a pure function of (seed, step), and ``make_batch_specs``."""

from repro_torch.data.pipeline import SyntheticLM, make_batch_specs

__all__ = ["SyntheticLM", "make_batch_specs"]
