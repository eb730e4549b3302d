"""Message-update backends, addressable by ``BPConfig.backend`` string.

The port of ``repro.kernels.ops`` for one graph. Every backend is a
``(pgm, logm) -> (cand (E, S), resid (E,))`` callable:

- ``"ref"``: plain torch sum-product (``messages.ref_update``);
- ``"maxprod"``: plain torch max-product (``messages.max_product_update``);
- ``"triton"``: the edge prelude in torch, then the hand-written CUDA
  kernel ``triton_update.fused_update_e`` (its plain version on CPU
  tensors). The name is the reference's, so a ``BPConfig.to_dict()`` from
  either package loads in the other; ``semiring="max"`` serves MAP.

The reference's ``"pallas"`` (TPU-layout kernel) and ``"sharded"`` backends
and the batched registry are not ported yet (ROADMAP queues 1-2); looking
them up raises the registry's uniform ``KeyError``.
"""

from __future__ import annotations

import torch

from repro_torch.core import messages as M
from repro_torch.core.graph import PGM
from repro_torch.core.registry import Registry
from repro_torch.kernels.triton_update import fused_update_e

__all__ = ["UPDATE_BACKENDS", "triton_update", "make_triton_update",
           "register_update_backend", "list_backends", "get_update_fn"]


def triton_update(pgm: PGM, logm: torch.Tensor, *, semiring: str = "sum"):
    """(cand (E, S), resid (E,)) -- kernel-backed ``ref_update`` (or, with
    ``semiring="max"``, ``max_product_update``) equivalent. Edge-major all
    the way; the kernel takes the graph's precomputed int8 ``dst_mask``.
    Like the reference kernel path, padded edges are not masked out of the
    residual here (they are inert: zero residual by construction)."""
    pre = M.edge_prelude(pgm, logm)
    return fused_update_e(pgm.log_psi_e, pre, logm, pgm.dst_mask,
                          semiring=semiring)


def make_triton_update(*, semiring: str = "sum"):
    """Closure for ``BPConfig(backend="triton")``: the fused kernel update
    with a fixed semiring (``"sum"`` or ``"max"``)."""
    def update_fn(pgm: PGM, logm: torch.Tensor):
        return triton_update(pgm, logm, semiring=semiring)

    return update_fn


#: name -> zero/kwarg factory returning an ``update_fn``.
UPDATE_BACKENDS = Registry("update backend", {
    "ref": lambda: M.ref_update,
    "maxprod": lambda: M.max_product_update,
    "triton": make_triton_update,
})


def register_update_backend(name: str, *, overwrite: bool = False):
    """Decorator registering an update-backend factory under ``name``
    (lowercased). Duplicates raise ``ValueError`` unless
    ``overwrite=True``."""
    return UPDATE_BACKENDS.register(name, overwrite=overwrite)


def list_backends():
    """Sorted registered backend names (valid ``BPConfig.backend``
    specs)."""
    return UPDATE_BACKENDS.names()


def get_update_fn(name: str, **kwargs):
    """Resolve a backend name to an update callable; ``kwargs`` (e.g.
    ``semiring=``) pass through to the factory."""
    return UPDATE_BACKENDS.lookup(name)(**kwargs)
