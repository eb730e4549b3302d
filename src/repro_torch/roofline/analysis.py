"""Model FLOPs of a training or serving step: a copy of
``repro.roofline.analysis.model_flops``, pure arithmetic on the parameter
tree. The rest of the reference's ``analysis`` and ``jaxpr_cost`` reads
XLA's compiled output and has no twin here (ROADMAP queue 1, item 13)."""

from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.models.model import stacked_ndim


def model_flops(param_specs: Mapping, n_tokens: float, *, cfg=None,
                kind: str = "train") -> float:
    """6*N*D (dense) / 6*N_active*D (MoE), D = processed tokens.

    ``param_specs`` maps the port's parameter names to anything with a
    ``shape`` (``dict(model.named_parameters())``, ``train_state_specs``'s
    meta tensors). kind: train -> 6ND (fwd+bwd); prefill/decode -> 2ND
    (fwd only). Expert leaves (3-D on the reference's stacked tree, leading
    dim = n_experts per layer) are scaled by the active fraction
    top_k / n_experts."""
    total = 0.0
    for name, leaf in param_specs.items():
        n = float(np.prod(leaf.shape))
        if cfg is not None and cfg.n_experts and \
                stacked_ndim(name, leaf) >= 3 and \
                ("moe" in name and "shared" not in name
                 and "router" not in name):
            # stacked experts: (L, E, a, b) or (E, a, b)
            n *= cfg.experts_per_token / cfg.n_experts
        total += n
    mult = 6.0 if kind == "train" else 2.0
    return mult * total * n_tokens
