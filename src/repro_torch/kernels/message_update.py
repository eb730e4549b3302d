"""Fused BP message update in the TPU's layout: the ``"pallas"`` backend's
kernel.

The module keeps the name of its JAX counterpart,
``repro.kernels.message_update``, but the body is CUDA C++ for Hopper:
``csrc/fused_update_t.cu``, built by ``nvcc`` at first use (``_build``)
and called through ``ctypes``. It replaces the Pallas kernel
``_fused_kernel``: sum-product with every operand transposed, edges last.
On the card a block owns a tile of consecutive edges and stages its table
slice in shared memory by asynchronous copies, a chunk of destination
states at a time (``plan_t`` computes the launch plan on the host).

``fused_update_t`` is the wrapper. It checks device, dtype, shape and
contiguity, then calls the dispatcher op ``repro_torch::fused_update_t``
(``_dispatch``), which

- for CPU tensors runs the plain torch version
  (``repro_torch.kernels.ref.fused_update_t_ref``);
- for CUDA tensors launches the kernel on the current stream, or raises.
  Nothing falls back to the plain version;
- for fake tensors gives the results' shapes.

The reference's TPU sizing (``pick_block_edges``, 128-lane blocks, edge
padding to a block multiple) has no counterpart: the kernel masks its own
last tile. ``LAUNCHES`` counts kernel launches, and only launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, _dispatch
from repro_torch.kernels.ref import fused_update_t_ref
from repro_torch.kernels.triton_update import (N_SMS_H100, LaunchPlan,
                                               _n_sms, blocks_per_sm,
                                               check_operands)

__all__ = ["fused_update_t", "LAUNCHES", "reset_launch_counts", "plan_t",
           "STAGED_MAX_STATES"]

#: largest S of the staged variant (kStagedMaxStates in the .cu source);
#: above it the one-thread-per-edge walk runs
STAGED_MAX_STATES = 256

#: kernel launches since the last ``reset_launch_counts`` (sum-product only)
LAUNCHES: Dict[str, int] = {"sum": 0}

_lib = None
#: (device index, S <= 16, threads, shared memory) -> (SMs, resident
#: blocks per SM); S <= 16 runs the kernel's register-column instance
_RESIDENT: Dict[Tuple, Tuple[int, int]] = {}


def reset_launch_counts() -> None:
    """Set the launch count to 0."""
    LAUNCHES["sum"] = 0


#: shared memory that fixes the chunk width C of a state count (bytes)
STAGED_SMEM_BUDGET = 200 * 1024


def _staged_smem(s: int, c: int, eb: int) -> int:
    # staged_smem_bytes() in fused_update_t.cu: two stages
    return (4 * (2 * (s * c * (eb + 4) + 2 * s * eb) + 2 * s * (eb + 1))
            + 2 * s * eb)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def plan_t(n_edges: int, n_states: int, n_sms: int = N_SMS_H100,
           resident: int = 0) -> LaunchPlan:
    """Launch plan of ``fused_update_t`` (mirrors ``staged_plan_ok`` and
    ``staged_smem_bytes`` in ``csrc/fused_update_t.cu``).

    ``"staged"`` (S <= 256): ``xj_chunk`` = C destination states per chunk,
    one thread per (state of the chunk, edge of the tile), C fixed by S
    (the largest power of two up to min(S, 32) whose smallest tile fits
    in 200 KB); each (edge, state) sums its source states in order and one
    thread per edge takes the normalizer over the states in order.
    ``tile_edges`` is 8 (one 32-byte sector per row load; a whole warp at
    least) unless E is large enough to give every SM two tiles of a wider
    one: 256 threads (512 when C > 8) walking tiles of about 2,048 staged
    floats, a stage of at most 64 KB. Copies are 16 bytes when
    E % 4 == 0, else 4, two stages deep. A persistent grid of ``n_sms`` x ``resident``
    blocks (the kernel's occupancy, asked by the wrapper; 0 takes an
    estimate) walks the tiles in one wave. ``"walk"`` (S > 256): one
    thread per edge.
    """
    e, s = int(n_edges), int(n_states)
    if s < 1:
        raise ValueError(f"fused_update_t needs at least one state, got {s}")
    if s > STAGED_MAX_STATES:
        return LaunchPlan("walk", 1, 1, "xi sequential; xj sequential",
                          256, 256, 0, max(1, -(-e // 256)), -(-e // 256))
    c = _pow2_floor(min(s, 32))
    while c > 1 and _staged_smem(s, c, max(8, 32 // c)) > STAGED_SMEM_BUDGET:
        c //= 2
    eb = max(8, 32 // c)                 # whole warps: C * EB >= 32
    threads = c * eb
    # large E: 256 or 512 threads walk tiles of about 2,048 staged floats
    # per stage (a few passes of threads / C edges each)
    wide_threads = 256 if c <= 8 else 512
    wide = max(wide_threads // c, _pow2_floor(max(1, 2048 // (s * c))))
    if s * c * (wide + 4) * 4 <= 65536 and -(-e // wide) >= 2 * n_sms:
        eb, threads = wide, wide_threads
    smem = _staged_smem(s, c, eb)
    n_tiles = -(-e // eb)
    resident = resident or blocks_per_sm(threads, smem)
    grid = max(1, min(n_tiles, n_sms * resident))
    return LaunchPlan("staged", c, 1, "xi sequential per (edge, xj); "
                      "xj sequential by one thread per edge", eb, threads,
                      smem, grid, n_tiles, xj_chunk=c,
                      vec=4 if e % 4 == 0 else 1)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_update_t")
        fn = lib.fused_update_t_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.fused_update_t_occupancy
        occ.argtypes = [ctypes.c_int] * 3
        occ.restype = ctypes.c_int
        _lib = lib
    return _lib.fused_update_t_launch


def _plan(e: int, s: int, device) -> LaunchPlan:
    """``plan_t`` with the card's SM count and the staged kernel's
    occupancy, asked once per (device, block shape)."""
    plan = plan_t(e, s)
    if plan.variant != "staged":
        return plan
    key = (device.index, s <= 16, plan.threads, plan.smem_bytes)
    if key not in _RESIDENT:
        blocks = _lib.fused_update_t_occupancy(s, plan.threads,
                                               plan.smem_bytes)
        if blocks < 1:
            raise RuntimeError(f"fused_update_t: no block of {plan.threads} "
                               f"threads and {plan.smem_bytes} bytes of "
                               f"shared memory fits an SM (S={s})")
        _RESIDENT[key] = (_n_sms(device), blocks)
    return plan_t(e, s, *_RESIDENT[key])


def fused_update_t(logpsi_t: torch.Tensor,   # (S, S, E) [x_src, x_dst, e]
                   pre_t: torch.Tensor,      # (S, E) source-side belief
                   logm_t: torch.Tensor,     # (S, E) current messages
                   dmask_t: torch.Tensor):   # (S, E) int8 valid dst states
    """Fused propagate -> normalize -> residual update, states first.

    Returns ``(new_logm_t (S, E) f32, residual (E,) f32)``, sum-product.
    Rows with no valid destination state give NEG_INF messages and a 0
    residual. It calls the dispatcher op
    ``torch.ops.repro_torch.fused_update_t``: CPU tensors run the plain
    torch version; CUDA tensors launch the hand-written kernel on
    ``torch.cuda.current_stream()`` and raise if it cannot build or launch;
    fake tensors get the shapes only.
    """
    if pre_t.dim() != 2:
        raise ValueError(f"pre_t must be (S, E), got {tuple(pre_t.shape)}")
    s, e = pre_t.shape
    check_operands({"logpsi_t": (logpsi_t, (s, s, e), torch.float32),
                    "pre_t": (pre_t, (s, e), torch.float32),
                    "logm_t": (logm_t, (s, e), torch.float32),
                    "dmask_t": (dmask_t, (s, e), torch.int8)}, pre_t.device)
    dev = pre_t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_update_t runs on cpu or cuda, not {dev}")
    return torch.ops.repro_torch.fused_update_t(logpsi_t, pre_t, logm_t,
                                                dmask_t)


def _launch(logpsi_t, pre_t, logm_t, dmask_t):
    """The op's CUDA implementation: one launch of the kernel on the
    current stream (operands checked by ``fused_update_t``)."""
    dev = pre_t.device
    s, e = pre_t.shape
    launch = _kernel()
    if any(t.data_ptr() % 16 for t in (logpsi_t, pre_t, logm_t, dmask_t)):
        raise ValueError("every operand must start on a 16-byte boundary "
                         "(the kernel stages them by async copies)")
    new_t = torch.empty((s, e), dtype=torch.float32, device=dev)
    resid = torch.empty((e,), dtype=torch.float32, device=dev)
    if e == 0:
        return new_t, resid
    plan = _plan(e, s, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(logpsi_t.data_ptr(), pre_t.data_ptr(), logm_t.data_ptr(),
                     dmask_t.data_ptr(), new_t.data_ptr(), resid.data_ptr(),
                     e, s, 1 if plan.variant == "staged" else 0,
                     plan.xj_chunk, plan.tile_edges, plan.vec, plan.threads,
                     plan.smem_bytes, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"fused_update_t kernel launch failed: cudaError "
                           f"{err} (E={e}, S={s})")
    LAUNCHES["sum"] += 1
    return new_t, resid


def _shapes(logpsi_t, pre_t, logm_t, dmask_t):
    """The op's fake implementation: the results' shapes, nothing run."""
    s, e = pre_t.shape
    return pre_t.new_empty((s, e)), pre_t.new_empty((e,))


#: ``repro_torch::fused_update_t``: the plain version on the CPU, the
#: kernel on CUDA, shapes on fake tensors
_LIB = _dispatch.define(
    "fused_update_t(Tensor logpsi_t, Tensor pre_t, Tensor logm_t, "
    "Tensor dmask_t) -> (Tensor, Tensor)",
    cpu=fused_update_t_ref, cuda=_launch, fake=_shapes)
