"""Hand-written CUDA kernels of the port and their plain torch versions.

``triton_update.fused_update_e`` (CUDA C++ in ``csrc/fused_update_e.cu``)
replaces the JAX package's Pallas kernels ``_sum_kernel``/``_max_kernel``;
``message_update.fused_update_t`` (``csrc/fused_update_t.cu``) replaces
``_fused_kernel``; ``edge_prelude.edge_prelude`` (``csrc/edge_prelude.cu``)
builds the kernel backends' edge prelude, which the reference leaves to
plain jnp. All three are built by ``_build``. ``ref`` holds the update
kernels' plain versions, ``edge_prelude`` its own twin; ``ops`` registers
the update backends and folds them over a bucket.
(``ops.triton_update`` and ``edge_prelude.edge_prelude`` are not
re-exported here: the names are the submodules'; the ``LAUNCHES``
counters live in their modules.)
"""

from repro_torch.kernels.ops import (BATCH_UPDATE_BACKENDS, UPDATE_BACKENDS,
                                     get_update_fn, kernel_operands_t,
                                     list_backends, make_pallas_update,
                                     make_pallas_update_batch,
                                     make_triton_update,
                                     make_triton_update_batch, pallas_update,
                                     pallas_update_batch,
                                     register_update_backend,
                                     triton_update_batch)
from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
from repro_torch.kernels.message_update import fused_update_t
from repro_torch.kernels.triton_update import (LAUNCHES, fused_update_e,
                                               reset_launch_counts)

__all__ = ["UPDATE_BACKENDS", "BATCH_UPDATE_BACKENDS", "get_update_fn",
           "kernel_operands_t", "list_backends", "make_pallas_update",
           "make_pallas_update_batch", "make_triton_update",
           "make_triton_update_batch", "pallas_update", "pallas_update_batch",
           "register_update_backend", "triton_update_batch",
           "fused_update_e_ref", "fused_update_t_ref", "fused_update_t",
           "LAUNCHES", "fused_update_e", "reset_launch_counts"]
