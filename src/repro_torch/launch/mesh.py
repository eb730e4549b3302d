"""Production mesh factories and the mesh queries of the sharding rules (a
port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` whose dimensions are named
(``mesh_dim_names``): ``("data", "model")``, or ``("pod", "data",
"model")`` across pods. "data" carries batch, "model" carries tensor and
expert parallelism. ``repro_torch.ft.ElasticMesh`` builds the 2-D mesh of
whatever world is initialized; ``make_production_mesh`` builds the
production layout, 256 ranks as 16 x 16 per pod, and two pods as
2 x 16 x 16.

The rules only read axis names and sizes, so they also take an
``AbstractMesh`` (the twin of ``jax.sharding.AbstractMesh``): a shape with
names and no ranks, for asking what a layout would be at a size no world
here has.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

__all__ = ["AbstractMesh", "axis_sizes", "axes_group", "data_axes",
           "data_size", "model_size", "make_production_mesh"]


class AbstractMesh:
    """Axis names and sizes with no devices behind them; answers
    ``mesh_dim_names`` and ``size(i)`` as a ``DeviceMesh`` does."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError(f"{len(shape)} sizes for {len(names)} axes")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)

    def size(self, dim: int | None = None) -> int:
        if dim is None:
            out = 1
            for n in self.shape:
                out *= n
            return out
        return self.shape[dim]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in data_axes(mesh):
        out *= sizes[a]
    return out


def model_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def axes_group(mesh, axes) -> Tuple[int, object]:
    """``(size, process group)`` of the ranks of ``mesh`` that differ from
    this one only along ``axes`` (a name or a tuple of names), ordered
    row-major over them as ``NamedSharding`` lays out a dimension split
    over that tuple; ``(1, None)`` when those axes hold one rank. Axes of
    one rank are skipped; several others are flattened into one group
    (the world's own group when they span it in order)."""
    import torch.distributed as dist
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    live = tuple(a for a in axes if sizes[a] > 1)
    size = 1
    for a in live:
        size *= sizes[a]
    if not live:
        return 1, None
    if len(live) == 1:
        return size, mesh.get_group(live[0])
    names = tuple(mesh.mesh_dim_names)
    spans_world = (size == dist.get_world_size() and
                   live == tuple(a for a in names if sizes[a] > 1) and
                   mesh.mesh.flatten().tolist() == list(range(size)))
    if spans_world:
        return size, dist.group.WORLD
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if live not in cache:
        cache[live] = mesh[live]._flatten("_".join(live)).get_group()
    return size, cache[live]


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production ``DeviceMesh``: ``(16, 16)`` over ``("data",
    "model")`` from a world of 256 ranks, or ``(2, 16, 16)`` over ``("pod",
    "data", "model")`` from 512 with ``multi_pod``. Any other world size
    raises a ``ValueError`` naming it; no world raises a ``RuntimeError``
    (the mesh never makes one)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.graph import resolve_device
    from repro_torch.dist import require_world
    import torch.distributed as dist
    dev = resolve_device(device)
    require_world()
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) lays {need} ranks "
            f"out as {shape}; this world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)
