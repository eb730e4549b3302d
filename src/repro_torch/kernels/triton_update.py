"""Fused BP message update, edge-major: the ``"triton"`` backend's kernel.

The module keeps the name of its JAX counterpart,
``repro.kernels.triton_update``, so a reader finds one from the other, but
the body is now CUDA C++ for Hopper: ``csrc/fused_update_e.cu``, one source
templated on the semiring, built by ``nvcc`` at first use (``_build``) and
called through ``ctypes``. It replaces the Pallas kernels ``_sum_kernel``
and ``_max_kernel``.

``fused_update_e`` is the wrapper. It checks device, dtype, shape and
contiguity, then

- for CPU tensors runs the plain torch version
  (``repro_torch.kernels.ref.fused_update_e_ref``);
- for CUDA tensors launches the kernel on the current stream, or raises.
  Nothing falls back to the plain version.

Unlike the reference it pads nothing: no power-of-two state padding and no
edge padding to a block multiple, so no padded copies are made per call.
``LAUNCHES`` counts kernel launches per semiring, and only launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_update_e_ref

__all__ = ["fused_update_e", "LAUNCHES", "reset_launch_counts", "MAX_STATES",
           "SEMIRINGS"]

#: semiring name -> the kernel's semiring code
SEMIRINGS = {"sum": 0, "max": 1}
#: largest state count the kernel takes (kMaxStates in the .cu source)
MAX_STATES = 128
#: kernel launches per semiring since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {"sum": 0, "max": 0}

_lib = None


def reset_launch_counts() -> None:
    """Set every semiring's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_update_e")
        fn = lib.fused_update_e_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.fused_update_e_launch


def _check(logpsi, pre, logm, dmask, semiring):
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         f"expected one of {sorted(SEMIRINGS)}")
    if pre.dim() != 2:
        raise ValueError(f"pre must be (E, S), got {tuple(pre.shape)}")
    e, s = pre.shape
    want = {"logpsi": (logpsi, (e, s, s), torch.float32),
            "pre": (pre, (e, s), torch.float32),
            "logm": (logm, (e, s), torch.float32),
            "dmask": (dmask, (e, s), torch.int8)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != pre.device:
            raise ValueError(f"{name} is on {t.device}, pre on {pre.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_update_e(logpsi: torch.Tensor,   # (E, S, S) f32 [e, x_src, x_dst]
                   pre: torch.Tensor,      # (E, S) f32 source-side belief
                   logm: torch.Tensor,     # (E, S) f32 current messages
                   dmask: torch.Tensor,    # (E, S) int8 valid dst states
                   semiring: str = "sum"):
    """Fused propagate -> normalize -> residual update, edge-major.

    Returns ``(new_logm (E, S) f32, residual (E,) f32)``: ``"sum"`` is
    sum-product (LSE propagate, LSE-normalize), ``"max"`` is max-product
    (max propagate, peak-normalize). Rows with no valid destination state
    give NEG_INF messages and a 0 residual. CPU tensors run the plain torch
    version; CUDA tensors launch the hand-written kernel on
    ``torch.cuda.current_stream()`` and raise if it cannot build or launch.
    """
    _check(logpsi, pre, logm, dmask, semiring)
    dev = pre.device
    if dev.type == "cpu":
        return fused_update_e_ref(logpsi, pre, logm, dmask, semiring)
    if dev.type != "cuda":
        raise ValueError(f"fused_update_e runs on cpu or cuda, not {dev}")
    e, s = pre.shape
    if s > MAX_STATES:
        raise ValueError(f"fused_update_e takes at most {MAX_STATES} states, "
                         f"got {s}")
    launch = _kernel()
    new = torch.empty((e, s), dtype=torch.float32, device=dev)
    resid = torch.empty((e,), dtype=torch.float32, device=dev)
    if e == 0:
        return new, resid
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(logpsi.data_ptr(), pre.data_ptr(), logm.data_ptr(),
                     dmask.data_ptr(), new.data_ptr(), resid.data_ptr(),
                     e, s, SEMIRINGS[semiring], stream)
    if err != 0:
        raise RuntimeError(f"fused_update_e kernel launch failed: cudaError "
                           f"{err} (E={e}, S={s}, semiring={semiring!r})")
    LAUNCHES[semiring] += 1
    return new, resid
