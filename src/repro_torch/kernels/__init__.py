"""Hand-written CUDA kernels of the port and their plain torch versions.

``triton_update.fused_update_e`` (CUDA C++ in ``csrc/fused_update_e.cu``,
built by ``_build``) replaces the JAX package's Pallas kernels
``_sum_kernel``/``_max_kernel``; ``ref.fused_update_e_ref`` is its plain
version; ``ops`` registers the update backends. (``ops.triton_update`` is
not re-exported here: the name is the submodule's.)
"""

from repro_torch.kernels.ops import (UPDATE_BACKENDS, get_update_fn,
                                     list_backends, make_triton_update,
                                     register_update_backend)
from repro_torch.kernels.ref import fused_update_e_ref
from repro_torch.kernels.triton_update import (LAUNCHES, fused_update_e,
                                               reset_launch_counts)

__all__ = ["UPDATE_BACKENDS", "get_update_fn", "list_backends",
           "make_triton_update", "register_update_backend",
           "fused_update_e_ref", "LAUNCHES", "fused_update_e",
           "reset_launch_counts"]
