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
the axis holds bitwise the same activations.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch


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
        """The rank-order sum of every rank's ``t``."""
        from repro_torch.dist import comm
        return comm.rank_order_sum(t, self.group)

    def all(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order."""
        from repro_torch.dist import comm
        return comm.all_gather(t.contiguous(), self.group)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        from repro_torch.dist import comm
        return comm.all_gather_cat(t, dim, self.group)

    def gather_parts(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each of ``ts`` (equal but for the last dimension) concatenated
        over the ranks along its last dimension, with one gather."""
        from repro_torch.dist import comm
        widths = [t.shape[-1] for t in ts]
        parts = comm.all_gather(torch.cat(list(ts), dim=-1), self.group)
        pieces = [torch.split(part, widths, dim=-1) for part in parts]
        return [torch.cat([pc[i] for pc in pieces], dim=-1)
                for i in range(len(ts))]
