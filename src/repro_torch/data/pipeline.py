"""Deterministic synthetic LM data pipeline (a port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), so the pipeline "cursor" in
a checkpoint is just the step counter: a resumed run sees the batches an
unbroken one would. Each batch is drawn on the host from a
``torch.Generator`` seeded with SplitMix64 of (seed, step)
(``core.batch.slot_seed``, where the reference folds the step into a
threefry key), so it does not depend on the device, and then copied to the
pipeline's device through pinned memory without a host synchronization.
The numbers differ from the reference's; the transforms are its own.

Token stream: Zipf-distributed ids over the vocab with a Markov bigram kick
so the loss has learnable structure (pure uniform tokens give a flat loss
-- useless for the convergence examples).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.batch import slot_generator
from repro_torch.core.graph import resolve_device


def make_batch_specs(cfg: ArchConfig, shape: InputShape,
                     dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One *global* training batch's tensors on the meta device (shapes and
    dtypes, nothing allocated)."""
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.frontend == "vision":
        t = cfg.n_frontend_tokens
        specs["frontend_embeds"] = torch.empty((b, t, cfg.d_model),
                                               dtype=dtype, device="meta")
        s = s - t                       # total sequence stays shape.seq_len
    if cfg.frontend == "audio":
        specs["frontend_embeds"] = torch.empty((b, s, cfg.d_model),
                                               dtype=dtype, device="meta")
    specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device="meta")
    specs["labels"] = torch.empty((b, s), dtype=torch.int32, device="meta")
    return specs


@dataclasses.dataclass
class SyntheticLM:
    """Batches of ``shape`` for ``cfg`` from ``seed``, on ``device`` (the
    GPU unless the caller passes ``device="cpu"``)."""
    cfg: ArchConfig
    shape: InputShape
    seed: int = 0
    device: torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg, shape = self.cfg, self.shape
        g = slot_generator(self.seed, step, "cpu")
        b, s = shape.global_batch, shape.seq_len
        if cfg.frontend == "vision":
            s = s - cfg.n_frontend_tokens  # total sequence stays seq_len
        # draws in a fixed order: ids, coins, then the frontend stub
        u = torch.rand((b, s + 1), generator=g)
        coin = torch.rand((b, s + 1), generator=g) < 0.5
        extra = {}
        if cfg.frontend in ("vision", "audio"):
            t = cfg.n_frontend_tokens if cfg.frontend == "vision" else s
            extra["frontend_embeds"] = 0.02 * torch.randn(
                (b, t, cfg.d_model), generator=g, dtype=torch.bfloat16)
        # Zipf-ish marginal: id = floor(v * u^3) biases mass to small ids.
        toks = torch.clamp_max((cfg.vocab * u ** 3).to(torch.int32),
                               cfg.vocab - 1)
        # Markov kick: with prob .5, token t+1 = (token t * 7 + 13) % vocab
        # -- a fixed learnable bigram rule.
        nxt = (toks * 7 + 13) % cfg.vocab
        toks = torch.where(coin, torch.roll(nxt, 1, dims=1), toks)
        host = dict(extra, tokens=toks[:, :s], labels=toks[:, 1:s + 1])
        if self.device.type == "cpu":
            return {k: v.contiguous() for k, v in host.items()}
        return {k: v.contiguous().pin_memory().to(self.device,
                                                  non_blocking=True)
                for k, v in host.items()}
