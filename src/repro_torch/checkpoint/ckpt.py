"""Device-agnostic checkpointing with atomic commit.

The port of ``repro.checkpoint.ckpt``, with the same on-disk format, so a
checkpoint of a numpy tree written by either package restores in the
other. One directory per step --
    <dir>/step_000000123.tmp/ (written) -> atomic rename -> step_000000123/
        manifest.json   {step, keys, shapes, dtypes, extra}
        data.npz        flattened leaves keyed by tree path

A tree is nested dicts, tuples, lists and dataclasses whose leaves are
tensors, numpy arrays or scalars; ``None`` holds no leaf. Leaf keys are the reference's pytree key paths joined by ``/`` (``['logm']``,
``['sstate']/[0]``, ``.field`` for attributes; dict keys in sorted order).
Leaves go to the host before saving, so a checkpoint written on one device
restores on any other: a leaf restores onto the device of the matching
leaf of ``like``.

Fault-tolerance contract: a crash mid-save leaves only a ``.tmp`` dir which
``latest_step`` ignores; the previous checkpoint stays valid.

From a mesh (``sharding_tree=`` and ``mesh=``, a tree of partition specs
beside a tree of the rank's blocks): ``save_pytree`` gathers each split
leaf whole, every rank taking part leaf by leaf in key order, rank 0 writes
the usual format, and every rank waits at a barrier until it has;
``restore_pytree`` loads each whole leaf and keeps the rank's block
(``shard_tensor``), as the reference's ``device_put`` against its
shardings does. A checkpoint written on one mesh restores on any other, on
one device, and in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["latest_step", "restore_pytree", "save_pytree"]


def _children(tree):
    """``[(key part, child)]`` of an inner node, ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for part, child in kids:
        yield from _leaves(child, f"{path}/{part}" if path else part)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _specs(specs, like, path: str = "") -> dict:
    """``{key path: spec}`` of a sharding tree laid out as ``like`` (its
    leaves are partition specs, which are tuples, so ``like``'s structure
    says where to stop)."""
    if like is None:
        return {}
    kids = _children(like)
    if kids is None:
        return {path: specs}
    out = {}
    for (part, child), key in zip(kids, (
            sorted(like) if isinstance(like, dict) else
            range(len(like)) if isinstance(like, (tuple, list)) else
            [f.name for f in dataclasses.fields(like)])):
        sub = specs[key] if isinstance(like, (dict, tuple, list)) \
            else getattr(specs, key)
        out.update(_specs(sub, child, f"{path}/{part}" if path else part))
    return out


def _split(spec) -> bool:
    return any(e is not None for e in spec or ())


def _gathered(tree, sharding_tree, mesh) -> dict:
    """The flat leaves of ``tree`` (the rank's blocks) whole, on rank 0;
    every rank takes part in each gather."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import gather_tensor
    specs = _specs(sharding_tree, tree)
    device = torch.device(mesh.device_type)
    out = {}
    for key, leaf in _leaves(tree):
        if _split(specs[key]):
            t = torch.as_tensor(_host(leaf)).to(device)
            leaf = gather_tensor(t, specs[key], mesh)
        if dist.get_rank() == 0:
            out[key] = _host(leaf)
    return out


def save_pytree(directory: str, step: int, tree: Any,
                extra: Optional[dict] = None, *, sharding_tree: Any = None,
                mesh=None) -> str:
    """Write ``tree`` as step ``step`` of ``directory`` (atomic commit);
    returns the step's directory. With ``sharding_tree`` and ``mesh`` the
    leaves are the rank's blocks: they are gathered whole, rank 0 writes,
    and every rank returns after a barrier."""
    name = f"step_{step:09d}"
    final = os.path.join(directory, name)
    if sharding_tree is not None:
        import torch.distributed as dist
        flat = _gathered(tree, sharding_tree, mesh)
        if dist.get_rank() == 0:
            _write(directory, name, step, flat, extra)
        dist.barrier()
        return final
    return _write(directory, name, step, _flatten(tree), extra)


def _write(directory: str, name: str, step: int, flat: dict,
           extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "data.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _rebuild(like, path: str, data, place):
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        arr = data[path]            # KeyError: not in this checkpoint
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"checkpoint leaf {path} has shape "
                             f"{arr.shape}, expected {np.shape(like)}")
        arr = place(path, arr)
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(like.device)
        return arr
    values = [_rebuild(child, f"{path}/{part}" if path else part, data,
                       place)
              for part, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), values))
    if isinstance(like, (tuple, list)):
        return type(like)(values)
    return dataclasses.replace(like, **{f.name: v for f, v in zip(
        dataclasses.fields(like), values) if f.init})


def restore_pytree(directory: str, step: int, like: Any,
                   sharding_tree: Any = None,
                   mesh=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree whose leaves have a
    ``shape``: tensors, arrays). A leaf of ``like`` that is a tensor
    restores as a tensor on its device; any other leaf as a numpy array.
    Returns ``(tree, extra)``; a key missing from the checkpoint raises
    ``KeyError``, a leaf of another shape ``ValueError``. With
    ``sharding_tree`` (specs laid out as ``like``) and ``mesh``, each leaf
    is checked whole and restores as this rank's block of it."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    place = lambda key, arr: arr                    # noqa: E731
    if sharding_tree is not None:
        from repro_torch.launch.sharding import shard_tensor
        specs = _specs(sharding_tree, like)

        def place(key, arr):
            if not _split(specs[key]):
                return arr
            return shard_tensor(torch.from_numpy(arr), specs[key],
                                mesh).numpy()
    with np.load(os.path.join(path, "data.npz")) as data:
        tree = _rebuild(like, "", data, place)
    return tree, manifest["extra"]
