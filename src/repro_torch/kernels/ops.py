"""Message-update backends, addressable by ``BPConfig.backend`` and
``BPConfig.batch_backend`` strings.

The port of ``repro.kernels.ops``. A single-graph backend is a
``(pgm, logm) -> (cand (E, S), resid (E,))`` callable:

- ``"ref"``: plain torch sum-product (``messages.ref_update``);
- ``"maxprod"``: plain torch max-product (``messages.max_product_update``);
- ``"triton"``: the edge prelude in torch, then the hand-written CUDA
  kernel ``triton_update.fused_update_e`` (edge-major); ``semiring="max"``
  serves MAP;
- ``"pallas"``: the edge prelude, then the hand-written CUDA kernel
  ``message_update.fused_update_t`` in the TPU's transposed layout. The
  graph's transposed table and mask are built once and kept with it
  (``PGM.operands_t``); ``pre`` and ``logm`` are transposed on every call
  and the result back to (E, S) -- three copies a call.

A bucket (``BatchedPGM``) runs folded into its kept disjoint union through
a single-graph backend -- one launch for the whole bucket. The reference's
batched backends ``"pallas"`` and ``"triton"`` are exactly that fold, so
here ``BPConfig.batch_backend=<name>`` resolves in one place
(``get_batch_update_fn``) as the fold of ``UPDATE_BACKENDS[<name>]``; only
the reference's two names are accepted, so configs interchange.
``pallas_update_batch``/``triton_update_batch`` keep the reference's
function names for the same fold.

- ``"sharded"``: the multi-device update of ``repro_torch.dist`` -- each
  rank of the ``torch.distributed`` world keeps and updates only its slice
  of the edge axis (``fused_update_e`` on the card) and the residuals are
  gathered. It resolves only inside an initialized world; outside one its
  factory raises a ``RuntimeError`` naming ``init_process_group``.

Each name is the reference's, so a ``BPConfig.to_dict()`` from either
package loads in the other. The reference's ``interpret=`` has no meaning
here.
"""

from __future__ import annotations

import torch

from repro_torch.core import messages as M
from repro_torch.core.graph import PGM
from repro_torch.core.registry import Registry
from repro_torch.kernels.message_update import fused_update_t
from repro_torch.kernels.triton_update import fused_update_e

__all__ = ["UPDATE_BACKENDS", "BATCH_BACKEND_NAMES", "kernel_operands_t",
           "pallas_update", "make_pallas_update", "pallas_update_batch",
           "make_pallas_update_batch", "triton_update", "make_triton_update",
           "triton_update_batch", "make_triton_update_batch",
           "make_sharded_update", "register_update_backend",
           "list_backends", "get_update_fn", "get_batch_update_fn"]


def kernel_operands_t(pgm: PGM):
    """``(logpsi_t (S, S, E), dmask_t (S, E))``: the graph's static
    TPU-layout operands, transposed once and kept with the graph."""
    return pgm.operands_t


def pallas_update(pgm: PGM, logm: torch.Tensor):
    """(cand (E, S), resid (E,)) -- ``ref_update`` through the TPU-layout
    kernel, with the reference's (E, S) layout at the boundary."""
    pre = M.edge_prelude(pgm, logm)
    logpsi_t, dmask_t = kernel_operands_t(pgm)
    new_t, resid = fused_update_t(logpsi_t, pre.t().contiguous(),
                                  logm.t().contiguous(), dmask_t)
    return new_t.t().contiguous(), resid


def make_pallas_update():
    """The ``"pallas"`` backend's update callable."""
    return pallas_update


def pallas_update_batch(batch, logm: torch.Tensor):
    """(cand (B, E, S), resid (B, E)) over a ``BatchedPGM``: the batch axis
    folds into the kernel's edge axis -- one launch over B*E edges, on the
    bucket's kept union and its kept transposed operands."""
    return batch.folded_update(pallas_update, logm)


def make_pallas_update_batch():
    """The batched ``"pallas"`` backend's update callable."""
    return pallas_update_batch


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


def triton_update_batch(batch, logm: torch.Tensor, *, semiring: str = "sum"):
    """(cand (B, E, S), resid (B, E)) bucket path: the same fold as
    ``pallas_update_batch`` through the edge-major kernel, no transposes."""
    return batch.folded_update(
        lambda pgm, lm: triton_update(pgm, lm, semiring=semiring), logm)


def make_triton_update_batch(*, semiring: str = "sum"):
    """Closure for ``BPConfig(batch_backend="triton")``: whole-bucket fused
    edge-major update in one launch, with a fixed semiring."""
    def batch_update_fn(batch, logm: torch.Tensor):
        return triton_update_batch(batch, logm, semiring=semiring)

    return batch_update_fn


def make_sharded_update(mesh=None, *, axis: str = "bp"):
    """The ``"sharded"`` backend's update callable
    (``repro_torch.dist.make_sharded_update``, imported at call time: the
    module needs the engine, which needs this registry)."""
    from repro_torch.dist import make_sharded_update as make
    return make(mesh, axis=axis)


#: name -> zero/kwarg factory returning an ``update_fn``.
UPDATE_BACKENDS = Registry("update backend", {
    "ref": lambda: M.ref_update,
    "maxprod": lambda: M.max_product_update,
    "pallas": make_pallas_update,
    "triton": make_triton_update,
    "sharded": make_sharded_update,
})

#: The ``BPConfig.batch_backend`` names (the reference's batched backends).
BATCH_BACKEND_NAMES = ("pallas", "triton")


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


def get_batch_update_fn(name: str, **kwargs):
    """Resolve ``BPConfig.batch_backend=name`` to a ``(batch, logm) ->
    (cand, resid)`` callable: the single-graph backend ``name`` run once on
    the bucket's folded union. Names outside ``BATCH_BACKEND_NAMES`` raise
    the registry's uniform ``KeyError``, as the reference's do."""
    if str(name).lower() not in BATCH_BACKEND_NAMES:
        raise KeyError(f"unknown batched update backend {name!r}; "
                       f"registered: {list(BATCH_BACKEND_NAMES)}")
    update_fn = get_update_fn(name, **kwargs)
    return lambda batch, logm: batch.folded_update(update_fn, logm)
