"""Tensor parallelism over a mesh's "model" axis, as the layers see it.

A layer function takes ``sh``: ``None`` on one device, or a ``Shard`` --
this rank's place on the axis and the collectives over it. On an axis of
one rank nothing is split and a layer computes as on one device. Which
weights are split comes from the specs of the parameters themselves
(``ParamTree.spec``, set by the sharding rules when the model was built on
a mesh), so a layer follows the rules' divisibility fallbacks leaf by
leaf: a replicated leaf computes whole, with no collective.

The collectives are ``repro_torch.dist.comm``'s: floats are gathered, never
``all_reduce``d, and a partial sum is added in rank order, so every rank of
the axis holds bitwise the same activations. They carry gradients: the sum's
backward is the identity, a gather's takes the rank's slice, and ``enter``
(the identity) marks where a replicated tensor feeds the rank's share of a
split computation, so its gradient, partial on each rank, is summed in rank
order. Every rank then holds the same gradient of a replicated tensor.

``Rows`` is the data-axis counterpart: the ranks over which the batch's
rows are split, for the sums that make a loss the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from repro_torch.dist import comm


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank on the "model" axis: ``mp`` ranks, index ``rank``,
    ``group`` its process group. ``seq`` says the decode cache in hand is
    split along its sequence over the axis (``cache_shardings``)."""
    mp: int
    rank: int
    group: object
    seq: bool = False

    @classmethod
    def of(cls, mesh) -> "Shard":
        """The ``Shard`` of this rank on ``mesh``."""
        axis = tuple(mesh.mesh_dim_names).index("model")
        mp = mesh.size(axis)
        return cls(mp=mp, rank=mesh.get_coordinate()[axis],
                   group=mesh.get_group("model") if mp > 1 else None)

    def split(self, p, key: str, dim: int) -> bool:
        """Whether leaf ``key`` of ``p`` is split over "model" along
        ``dim`` (False on an axis of one rank, and for a mapping that
        carries no specs)."""
        spec_of = getattr(p, "spec", None)
        spec = spec_of(key) if spec_of is not None else None
        return self.mp > 1 and bool(spec) and spec[dim] == "model"

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` (a multiple of ``mp``)."""
        size = n // self.mp
        return slice(self.rank * size, (self.rank + 1) * size)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The rank-order sum of every rank's ``t`` (backward: the
        identity)."""
        return comm.rank_order_sum(t, self.group)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, replicated on the axis, as the input of this rank's share
        of a split computation (backward: the rank-order sum)."""
        return comm.enter(t, self.group) if self.mp > 1 else t

    def all(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order (no autograd: decoding)."""
        return comm.all_gather(t.contiguous(), self.group)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order
        (backward: the rank's slice)."""
        return comm.all_gather_cat(t, dim, self.group)

    def gather_parts(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each of ``ts`` (equal but for the last dimension) concatenated
        over the ranks along its last dimension, with one gather."""
        widths = [t.shape[-1] for t in ts]
        parts = comm.all_gather_cat(torch.cat(list(ts), dim=-1)[None], 0,
                                    self.group)          # (mp, ..., sum w)
        out, at = [], 0
        for w in widths:
            piece = parts[..., at:at + w].movedim(0, -2)  # (..., mp, w)
            out.append(piece.reshape(*piece.shape[:-2], -1))
            at += w
        return out


def columns(p, x: torch.Tensor, keys: Sequence[str],
            sh: "Shard | None") -> Dict[str, torch.Tensor]:
    """``{key: x @ p[key]}`` for each of ``keys``, every product whole on
    every rank: ``x`` (replicated) enters the column-split weights, whose
    products are gathered together (one gather); replicated weights
    multiply whole."""
    split = [k for k in keys if sh is not None and sh.split(p, k, 1)]
    xe = sh.enter(x) if split else x
    out = {k: (xe if k in split else x) @ p[k].to(x.dtype) for k in keys}
    if split:
        out.update(zip(split, sh.gather_parts([out[k] for k in split])))
    return out


def row_parallel(p, key: str, x: torch.Tensor,
                 sh: "Shard | None") -> torch.Tensor:
    """``x @ p[key]`` for a replicated ``x``: a row-split weight takes the
    rank's slice of ``x``'s last dimension and the partial products are
    summed in rank order."""
    w = p[key].to(x.dtype)
    if sh is not None and sh.split(p, key, 0):
        return sh.sum(sh.enter(x)[..., sh.block(x.shape[-1])] @ w)
    return x @ w


@dataclasses.dataclass(frozen=True)
class Rows:
    """The ranks over which a batch's rows are split (``batch_shardings``):
    ``size`` of them in ``group``, along the mesh axes ``axes``, each
    holding as many rows. ``sum`` and ``count`` turn a rank's share of a
    loss's sums into the global batch's, the same on every rank."""
    size: int
    group: object
    axes: tuple

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The rank-order sum over the rows' ranks (backward: the
        identity: every rank's loss is the global one)."""
        return comm.rank_order_sum(t, self.group)

    def count(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of an integer tensor over the rows' ranks (exact)."""
        return comm.all_reduce_count(t.clone(), self.group)

