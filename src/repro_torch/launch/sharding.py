"""Sharding rules: parameters, optimizer state, batches, KV/SSM caches (a
port of ``repro.launch.sharding``), and the placement of a tensor by them.

Divisibility-aware resolver: a dimension is sharded over "model" only when
divisible by the axis size; otherwise the rule degrades to replication for
that leaf (correct, just less parallel -- e.g. hymba's 25 attention heads or
whisper's 51865-token vocab). Batch dims shard over ("pod", "data") when
divisible, and replicate otherwise (a batch of one).

Megatron-style defaults:
  column-parallel (shard output dim):  wq/wk/wv/w_in/w_gate/w_uq/... ,
  row-parallel    (shard input  dim):  wo/w_out/shared_w_out/proj ,
  MoE experts: tensor-parallel on d_ff (all experts resident per rank,
  no all-to-all),
  embeddings: vocab-sharded when divisible,
  KV caches: *sequence*-sharded over "model" (flash-decoding: each rank
  attends over its block of the keys and the ranks combine their softmax
  partials, instead of gathering the cache).

The rules return a ``P`` per leaf, keyed as the port names things: dotted
parameter names for ``param_shardings`` (``blocks.3.attn.wq``), the cache's
nested dict for ``cache_shardings``. The port holds one module per layer
where the reference stacks the layers on a leading axis, so a per-layer
leaf's spec is the reference's without its leading ``None``; the MTP
head's ``block`` is not a stack in either package.

Placement: ``shard_tensor(t, spec, mesh)`` is the rank's contiguous block
along each named dimension, in ``jax.sharding.NamedSharding``'s layout (a
dimension split over a tuple of axes is split row-major over them);
``gather_tensor`` inverts it exactly over the mesh's process groups, and
``unshard`` does the same from blocks already in hand.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes, data_axes, model_size

__all__ = ["P", "ROW_PARALLEL", "param_shardings", "train_state_shardings",
           "batch_shardings", "cache_shardings", "replicated", "local_shape",
           "shard_tensor", "gather_tensor", "unshard"]

ROW_PARALLEL = {"wo", "w_out", "shared_w_out", "proj"}


class P(tuple):
    """A partition spec: one entry per dimension, each ``None``
    (replicated), an axis name, or a tuple of axis names (one name stands
    for its 1-tuple, as ``jax.sharding.PartitionSpec`` has it). ``P()`` is
    a fully replicated leaf of any rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _leaf_name(name: str) -> str:
    """The last part of a dotted name (``blocks.3.attn.wq`` -> ``wq``)."""
    return name.rsplit(".", 1)[-1]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _param_pspec(name: str, shape, mp: int, stacked: bool = False) -> P:
    """The spec of one parameter leaf of ``shape``. ``stacked`` strips a
    leading layer axis (the reference's scan-stacked blocks); the port's
    per-layer leaves pass ``stacked=False``."""
    name = _leaf_name(name)
    shape = tuple(shape)[1:] if stacked else tuple(shape)
    nd = len(shape)
    lead = (None,) if stacked else ()

    def ok(d):
        return shape[d] % mp == 0 and shape[d] >= mp

    if nd <= 1:
        return P(*lead, *([None] * nd))
    if name == "table":                       # embedding / lm head
        if ok(0):
            return P(*lead, "model", None)
        return P(*lead, None, "model") if ok(1) else P(*lead, None, None)
    if nd == 3:                               # MoE expert stacks (E, a, b)
        if name in ROW_PARALLEL:
            return P(*lead, None, "model", None) if ok(1) \
                else P(*lead, None, None, None)
        return P(*lead, None, None, "model") if ok(2) \
            else P(*lead, None, None, None)
    if nd == 2:
        if name in ROW_PARALLEL:
            return P(*lead, "model", None) if ok(0) else P(*lead, None, None)
        return P(*lead, None, "model") if ok(1) else P(*lead, None, None)
    return P(*lead, *([None] * nd))


def _fsdp_pspec(name: str, shape, axes: tuple, axes_size: int,
                stacked: bool = False) -> P:
    """ZeRO-3: shard every parameter on its largest divisible trailing dim
    over the flattened (data, model) axes; leaves under 2**20 elements
    (norms, biases) replicate."""
    shape = tuple(shape)[1:] if stacked else tuple(shape)
    lead = (None,) if stacked else ()
    if not shape:
        return P(*lead)
    n_elems = 1
    for d in shape:
        n_elems *= d
    if n_elems < (1 << 20):
        return P(*lead, *([None] * len(shape)))
    if _leaf_name(name) == "table":    # embeddings: shard vocab rows
        dims = list(range(len(shape)))
    else:
        # prefer the output (last) dim: sharding the contracting dim turns
        # every x @ W into a partial sum
        dims = list(range(len(shape) - 1, -1, -1))
    for d in dims:
        if shape[d] % axes_size == 0 and shape[d] >= axes_size:
            spec = [None] * len(shape)
            spec[d] = axes
            return P(*lead, *spec)
    return P(*lead, *([None] * len(shape)))


def _rule(mesh, mode: str):
    """``(name, shape) -> P`` for a per-layer parameter under ``mode``."""
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"mode must be 'tp' or 'fsdp', got {mode!r}")
    sizes = axis_sizes(mesh)
    if mode == "fsdp":
        axes, size = ("data", "model"), sizes["data"] * sizes["model"]
        return lambda name, shape: _fsdp_pspec(name, shape, axes, size)
    mp = model_size(mesh)
    return lambda name, shape: _param_pspec(name, shape, mp)


def param_shardings(mesh, param_specs: Mapping[str, Any],
                    mode: str = "tp") -> Dict[str, P]:
    """``{parameter name: P}`` for ``Model.param_specs()`` (or any mapping
    of names to tensors or shapes).

    mode="tp": megatron tensor-parallel over "model" (baseline).
    mode="fsdp": ZeRO-3 over the flattened ("data", "model") axes."""
    rule = _rule(mesh, mode)
    return {name: rule(name, _shape(leaf))
            for name, leaf in param_specs.items()}


def train_state_shardings(mesh, state_specs, mode: str = "tp"):
    """A ``TrainState`` of specs: params and both AdamW moments share the
    parameter rules; the step and the moments' count replicate."""
    rules = lambda tree: param_shardings(mesh, tree, mode)  # noqa: E731
    opt = dataclasses.replace(state_specs.opt, mu=rules(state_specs.opt.mu),
                              nu=rules(state_specs.opt.nu), count=P())
    return dataclasses.replace(state_specs, params=rules(state_specs.params),
                               opt=opt, step=P())


def batch_shardings(mesh, batch_specs: Mapping[str, Any],
                    mode: str = "tp") -> Dict[str, P]:
    """tokens/labels (B, S) -> P(dp, None); frontend (B, T, d) likewise.
    mode="fsdp": batch shards over every axis, or ("data", "model") when
    that is what divides B, since no axis carries tensor parallelism."""
    sizes = axis_sizes(mesh)
    dp = tuple(mesh.mesh_dim_names) if mode == "fsdp" else data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    alt = ("data", "model")
    alt_size = sizes["data"] * sizes["model"]

    def rule(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        b = shape[0]
        first = dp if (b % dp_size == 0 and b >= dp_size) else None
        if first is None and mode == "fsdp" and b % alt_size == 0 \
                and b >= alt_size:
            first = alt
        return P(first, *([None] * (len(shape) - 1)))

    return {name: rule(leaf) for name, leaf in batch_specs.items()}


def cache_shardings(mesh, cache_specs):
    """Decode caches, ``{group: {name: spec}}`` of (L, B, ...) stacks:
      k/v/c_kv/k_rope/cross_*: (L, B, S, ...) -> seq on "model", B on data
      ssm state (L, B, H, P, N): heads, else head-dim P, on "model" when
      divisible; conv: batch-sharded only; pos: replicated."""
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    mp = model_size(mesh)

    def rule(name, shape):
        nd = len(shape)
        if name == "pos" or nd <= 1:
            return P()
        bdim = dp if (shape[1] % dp_size == 0 and shape[1] >= dp_size) \
            else None
        if name in ("k", "v", "c_kv", "k_rope", "cross_k", "cross_v"):
            sdim = "model" if shape[2] % mp == 0 and shape[2] >= mp else None
            return P(None, bdim, sdim, *([None] * (nd - 3)))
        if name == "ssm":                       # (L, B, H, P, N)
            if shape[2] % mp == 0 and shape[2] >= mp:
                return P(None, bdim, "model", None, None)
            if shape[3] % mp == 0 and shape[3] >= mp:
                return P(None, bdim, None, "model", None)
            return P(None, bdim, None, None, None)
        if name == "conv":                      # (L, B, K-1, C)
            return P(None, bdim, None, None)
        return P(None, bdim, *([None] * (nd - 2)))

    return {group: {name: rule(name, _shape(leaf))
                    for name, leaf in leaves.items()}
            for group, leaves in cache_specs.items()}


def replicated(mesh, tree):
    """``P()`` for every leaf of a nested dict."""
    if isinstance(tree, Mapping):
        return {k: replicated(mesh, v) for k, v in tree.items()}
    return P()


# ------------------------------------------------------------ placement --

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check(shape, spec, sizes) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    for dim, entry in enumerate(spec):
        n = 1
        for a in _axes(entry):
            n *= sizes[a]
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split {n} ways ({spec})")


def local_shape(shape, spec: Sequence, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    sizes = axis_sizes(mesh)
    shape = tuple(shape)
    _check(shape, spec, sizes)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[dim] //= sizes[a]
    return tuple(out)


def _coordinate(mesh, coordinate) -> Dict[str, int]:
    if coordinate is None:
        coordinate = mesh.get_coordinate()
        if coordinate is None:
            raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coordinate))


def _block_index(entry, coord: Mapping[str, int], sizes) -> Tuple[int, int]:
    """(the block's index, the number of blocks) along one dimension."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def shard_tensor(t: torch.Tensor, spec: Sequence, mesh,
                 coordinate: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The block of ``t`` that the rank at ``coordinate`` (default: this
    rank's, ``mesh.get_coordinate()``) holds under ``spec``, as a new
    contiguous tensor."""
    sizes = axis_sizes(mesh)
    _check(tuple(t.shape), spec, sizes)
    coord = _coordinate(mesh, coordinate)
    for dim, entry in enumerate(spec):
        idx, n = _block_index(entry, coord, sizes)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t.clone(memory_format=torch.contiguous_format)


def gather_tensor(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``t`` under ``spec``, on
    every rank: gathers along each split dimension over its axes' groups
    (the last axis of a tuple first), so the result is exactly the tensor
    that was split."""
    from repro_torch.dist import comm
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if sizes[a] > 1:
                t = comm.all_gather_cat(t, dim, mesh.get_group(a))
    return t


def unshard(blocks: Mapping[Tuple[int, ...], torch.Tensor], spec: Sequence,
            mesh) -> torch.Tensor:
    """The whole tensor from ``{rank coordinate: its block}`` over every
    coordinate of ``mesh`` (blocks of ranks that only differ along a
    replicated axis must be equal; one of them is used)."""
    sizes = axis_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    first = next(iter(blocks.values()))
    shape = list(first.shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= _block_index(entry, {a: 0 for a in names}, sizes)[1]
    out = first.new_empty(shape)
    for coordinate in itertools.product(*(range(sizes[a]) for a in names)):
        block = blocks[tuple(coordinate)]
        coord = dict(zip(names, coordinate))
        view = out
        for dim, entry in enumerate(spec):
            idx, n = _block_index(entry, coord, sizes)
            if n > 1:
                view = view.narrow(dim, idx * block.shape[dim],
                                   block.shape[dim])
        view.copy_(block)
    return out
