"""The weight carry between the reference's parameter pytree and the port's
``state_dict``, both ways.

``params_from_reference(cfg, tree)`` takes the tree that
``repro.models.Model.init_params`` returns, as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), unstacks the leading layer axis of
``lead_blocks``, ``blocks`` and ``enc_blocks`` into per-layer entries
(``blocks.3.attn.wq``) and puts each leaf in the port's storage dtype.
Matmul weights keep the reference's (in, out) layout, so nothing is
transposed. Then ``model.load_state_dict(...)`` makes the port compute the
reference's function.

``shard_state_dict(cfg, state, mesh)`` keeps this rank's blocks of such a
``state_dict``, as ``param_shardings`` places them, for a model built on
that mesh.

``params_to_reference(params)`` is the inverse: it stacks the per-layer
entries back on a leading L axis, in float32 numpy on the host, so a port
tree (parameters, or AdamW moments) saves under the reference's checkpoint
keys.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import param_shardings, shard_tensor
from repro_torch.models.model import (STACKS, model_dtype, param_specs,
                                      param_tree, storage_dtype)


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    for key, sub in tree.items():
        if isinstance(sub, dict):
            _flatten(sub, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = sub
    return out


def unstack_reference(tree) -> Dict[str, Any]:
    """The reference's tree as ``{port parameter name: array}``, each
    stacked leaf split into its layers."""
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
    return flat


def params_from_reference(cfg: ArchConfig, tree) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``Model(cfg)`` from the reference's params."""
    dt = model_dtype(cfg)
    return {name: torch.from_numpy(np.array(arr, np.float32)).to(
                storage_dtype(name, dt))
            for name, arr in unstack_reference(tree).items()}


def shard_state_dict(cfg: ArchConfig, state: Mapping[str, torch.Tensor],
                     mesh, mode: str = "tp") -> Dict[str, torch.Tensor]:
    """This rank's blocks of a whole ``state_dict`` of ``Model(cfg)``, for
    ``build_model(cfg, mesh=mesh, mode=mode)``."""
    specs = param_shardings(mesh, param_specs(cfg), mode)
    return {name: shard_tensor(t, specs[name], mesh)
            for name, t in state.items()}


def stack_like_reference(flat: Mapping[str, Any],
                         stack: Callable = np.stack) -> Dict[str, Any]:
    """``{port parameter name: leaf}`` as the reference's nested tree, each
    block stack's per-layer leaves joined by ``stack`` (a list of the
    layers' leaves -> one leaf)."""
    tree = param_tree(flat)
    for key in STACKS:
        if key in tree:
            layers = [_flatten(layer, "", {}) for layer in tree[key]]
            tree[key] = param_tree({name: stack([layer[name]
                                                 for layer in layers])
                                    for name in layers[0]})
    return tree


def _host32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def params_to_reference(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's params tree (float32 numpy, layers stacked on a
    leading L axis) from the port's ``{name: tensor}`` on any device."""
    return stack_like_reference({n: _host32(t) for n, t in params.items()})
