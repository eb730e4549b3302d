"""The weight carry: the reference's parameter pytree to the port's
``state_dict``.

``params_from_reference(cfg, tree)`` takes the tree that
``repro.models.Model.init_params`` returns, as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), unstacks the leading layer axis of
``lead_blocks``, ``blocks`` and ``enc_blocks`` into per-layer entries
(``blocks.3.attn.wq``) and puts each leaf in the port's storage dtype.
Matmul weights keep the reference's (in, out) layout, so nothing is
transposed. Then ``model.load_state_dict(...)`` makes the port compute the
reference's function.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import STACKS, model_dtype, storage_dtype


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    for key, sub in tree.items():
        if isinstance(sub, dict):
            _flatten(sub, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = sub
    return out


def params_from_reference(cfg: ArchConfig, tree) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``Model(cfg)`` from the reference's params."""
    flat: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key in STACKS:
            for name, arr in _flatten(sub, "", {}).items():
                for i in range(np.shape(arr)[0]):
                    flat[f"{key}.{i}.{name}"] = np.asarray(arr)[i]
        elif isinstance(sub, dict):
            _flatten(sub, key + ".", flat)
        else:
            flat[key] = sub
    dt = model_dtype(cfg)
    return {name: torch.from_numpy(np.array(arr, np.float32)).to(
                storage_dtype(name, dt))
            for name, arr in flat.items()}
