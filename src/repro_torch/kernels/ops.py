"""Message-update backends, addressable by ``BPConfig.backend`` and
``BPConfig.batch_backend`` strings.

The port of ``repro.kernels.ops``. A single-graph backend is a
``(pgm, logm) -> (cand (E, S), resid (E,))`` callable:

- ``"ref"``: plain torch sum-product (``messages.ref_update``);
- ``"maxprod"``: plain torch max-product (``messages.max_product_update``);
- ``"triton"``: the edge prelude (``edge_prelude.edge_prelude``, one
  hand-written CUDA kernel, bitwise ``messages.edge_prelude``), then the
  hand-written CUDA kernel ``triton_update.fused_update_e`` (edge-major);
  ``semiring="max"`` serves MAP;
- ``"pallas"``: the same edge prelude, then the hand-written CUDA kernel
  ``message_update.fused_update_t`` in the TPU's transposed layout. The
  graph's transposed table and mask are built once and kept with it
  (``PGM.operands_t``); ``pre`` and ``logm`` are transposed on every call
  and the result back to (E, S) -- three copies a call.

The two kernel backends mark their edge prelude as the span ``bp.prelude``
and ``"pallas"``'s copies as ``bp.transpose``
(``repro_torch.core.spans``).

A bucket (``BatchedPGM``) runs folded into its kept disjoint union through
a single-graph backend -- one launch for the whole bucket. A batched
backend is a ``(batch, logm (B, E, S)) -> (cand (B, E, S), resid (B, E))``
callable, named by ``BPConfig.batch_backend`` through
``BATCH_UPDATE_BACKENDS``, the reference's registry of the same name. Its
two entries, ``"pallas"`` and ``"triton"``
(``pallas_update_batch``/``triton_update_batch``), are that fold through
the single-graph backend of the same name, so they are bitwise the
engine's default fold; ``register_update_backend(name, batched=True)``
adds more.

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
from repro_torch.core import spans
from repro_torch.core.graph import PGM
from repro_torch.core.registry import Registry
from repro_torch.kernels.edge_prelude import edge_prelude
from repro_torch.kernels.message_update import fused_update_t
from repro_torch.kernels.triton_update import fused_update_e

__all__ = ["UPDATE_BACKENDS", "BATCH_UPDATE_BACKENDS", "kernel_operands_t",
           "pallas_update", "make_pallas_update", "pallas_update_batch",
           "make_pallas_update_batch", "triton_update", "make_triton_update",
           "triton_update_batch", "make_triton_update_batch",
           "make_sharded_update", "register_update_backend",
           "list_backends", "get_update_fn"]


def kernel_operands_t(pgm: PGM):
    """``(logpsi_t (S, S, E), dmask_t (S, E))``: the graph's static
    TPU-layout operands, transposed once and kept with the graph."""
    return pgm.operands_t


def pallas_update(pgm: PGM, logm: torch.Tensor):
    """(cand (E, S), resid (E,)) -- ``ref_update`` through the TPU-layout
    kernel, with the reference's (E, S) layout at the boundary."""
    on = spans.recording()
    if on:
        t = spans.begin("bp.prelude")
    pre = edge_prelude(pgm, logm)
    if on:
        spans.end(t)
    logpsi_t, dmask_t = kernel_operands_t(pgm)
    if on:
        t = spans.begin("bp.transpose")
    pre_t, logm_t = pre.t().contiguous(), logm.t().contiguous()
    if on:
        spans.end(t)
    new_t, resid = fused_update_t(logpsi_t, pre_t, logm_t, dmask_t)
    if on:
        t = spans.begin("bp.transpose")
    new = new_t.t().contiguous()
    if on:
        spans.end(t)
    return new, resid


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
    on = spans.recording()
    if on:
        t = spans.begin("bp.prelude")
    pre = edge_prelude(pgm, logm)
    if on:
        spans.end(t)
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

#: name -> zero/kwarg factory returning a batched ``(batch, logm)`` update.
BATCH_UPDATE_BACKENDS = Registry("batched update backend", {
    "pallas": make_pallas_update_batch,
    "triton": make_triton_update_batch,
})


def _registry(batched: bool) -> Registry:
    return BATCH_UPDATE_BACKENDS if batched else UPDATE_BACKENDS


def register_update_backend(name: str, *, batched: bool = False,
                            overwrite: bool = False):
    """Decorator registering an update-backend factory under ``name``
    (lowercased), in ``BATCH_UPDATE_BACKENDS`` when ``batched`` else in
    ``UPDATE_BACKENDS``. Duplicates raise ``ValueError`` unless
    ``overwrite=True``."""
    return _registry(batched).register(name, overwrite=overwrite)


def list_backends(*, batched: bool = False):
    """Sorted registered backend names: valid ``BPConfig.backend`` specs,
    or with ``batched=True`` valid ``BPConfig.batch_backend`` specs."""
    return _registry(batched).names()


def get_update_fn(name: str, *, batched: bool = False, **kwargs):
    """Resolve a backend name to an update callable (batched with
    ``batched=True``); ``kwargs`` (e.g. ``semiring=``) pass through to the
    factory. Unknown names raise the registry's uniform ``KeyError``."""
    return _registry(batched).lookup(name)(**kwargs)
