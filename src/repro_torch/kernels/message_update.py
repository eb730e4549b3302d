"""Fused BP message update in the TPU's layout: the ``"pallas"`` backend's
kernel.

The module keeps the name of its JAX counterpart,
``repro.kernels.message_update``, but the body is CUDA C++ for Hopper:
``csrc/fused_update_t.cu``, built by ``nvcc`` at first use (``_build``)
and called through ``ctypes``. It replaces the Pallas kernel
``_fused_kernel``: sum-product with every operand transposed, edges last
-- on the card, one thread per edge with coalesced loads.

``fused_update_t`` is the wrapper. It checks device, dtype, shape and
contiguity, then

- for CPU tensors runs the plain torch version
  (``repro_torch.kernels.ref.fused_update_t_ref``);
- for CUDA tensors launches the kernel on the current stream, or raises.
  Nothing falls back to the plain version.

The reference's TPU sizing (``pick_block_edges``, 128-lane blocks, edge
padding to a block multiple) has no counterpart: the kernel masks its own
last block. ``LAUNCHES`` counts kernel launches, and only launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_update_t_ref
from repro_torch.kernels.triton_update import check_operands

__all__ = ["fused_update_t", "LAUNCHES", "reset_launch_counts"]

#: kernel launches since the last ``reset_launch_counts`` (sum-product only)
LAUNCHES: Dict[str, int] = {"sum": 0}

_lib = None


def reset_launch_counts() -> None:
    """Set the launch count to 0."""
    LAUNCHES["sum"] = 0


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_update_t")
        fn = lib.fused_update_t_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.fused_update_t_launch


def fused_update_t(logpsi_t: torch.Tensor,   # (S, S, E) [x_src, x_dst, e]
                   pre_t: torch.Tensor,      # (S, E) source-side belief
                   logm_t: torch.Tensor,     # (S, E) current messages
                   dmask_t: torch.Tensor):   # (S, E) int8 valid dst states
    """Fused propagate -> normalize -> residual update, states first.

    Returns ``(new_logm_t (S, E) f32, residual (E,) f32)``, sum-product.
    Rows with no valid destination state give NEG_INF messages and a 0
    residual. CPU tensors run the plain torch version; CUDA tensors launch
    the hand-written kernel on ``torch.cuda.current_stream()`` and raise if
    it cannot build or launch.
    """
    if pre_t.dim() != 2:
        raise ValueError(f"pre_t must be (S, E), got {tuple(pre_t.shape)}")
    s, e = pre_t.shape
    check_operands({"logpsi_t": (logpsi_t, (s, s, e), torch.float32),
                    "pre_t": (pre_t, (s, e), torch.float32),
                    "logm_t": (logm_t, (s, e), torch.float32),
                    "dmask_t": (dmask_t, (s, e), torch.int8)}, pre_t.device)
    dev = pre_t.device
    if dev.type == "cpu":
        return fused_update_t_ref(logpsi_t, pre_t, logm_t, dmask_t)
    if dev.type != "cuda":
        raise ValueError(f"fused_update_t runs on cpu or cuda, not {dev}")
    launch = _kernel()
    new_t = torch.empty((s, e), dtype=torch.float32, device=dev)
    resid = torch.empty((e,), dtype=torch.float32, device=dev)
    if e == 0:
        return new_t, resid
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(logpsi_t.data_ptr(), pre_t.data_ptr(), logm_t.data_ptr(),
                     dmask_t.data_ptr(), new_t.data_ptr(), resid.data_ptr(),
                     e, s, stream)
    if err != 0:
        raise RuntimeError(f"fused_update_t kernel launch failed: cudaError "
                           f"{err} (E={e}, S={s})")
    LAUNCHES["sum"] += 1
    return new_t, resid
