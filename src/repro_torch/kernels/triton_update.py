"""Fused BP message update, edge-major: the ``"triton"`` backend's kernel.

The module keeps the name of its JAX counterpart,
``repro.kernels.triton_update``, so a reader finds one from the other, but
the body is now CUDA C++ for Hopper: ``csrc/fused_update_e.cu``, one source
templated on the semiring, built by ``nvcc`` at first use (``_build``) and
called through ``ctypes``. It replaces the Pallas kernels ``_sum_kernel``
and ``_max_kernel``.

``fused_update_e`` is the wrapper. It checks device, dtype, shape and
contiguity, then calls the dispatcher op ``repro_torch::fused_update_e``
(``_dispatch``), which

- for CPU tensors runs the plain torch version
  (``repro_torch.kernels.ref.fused_update_e_ref``);
- for CUDA tensors launches the kernel on the current stream, or raises.
  Nothing falls back to the plain version;
- for fake tensors gives the results' shapes, so a BP round runs under
  ``FakeTensorMode`` and ``roofline.op_cost`` charges the kernel by its
  cost model.

Unlike the reference it pads nothing: no power-of-two state padding and no
edge padding to a block multiple, so no padded copies are made per call.
``LAUNCHES`` counts kernel launches per semiring, and only launches.

``plan_e`` computes the launch plan on the host -- variant, lanes per edge,
source-state split, edges per tile, threads, shared memory, grid -- and the
launcher takes it as arguments, so the CPU tests can check the plan: an
edge's split depends on S alone, never on E.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, _dispatch
from repro_torch.kernels.ref import fused_update_e_ref

__all__ = ["fused_update_e", "LAUNCHES", "reset_launch_counts", "MAX_STATES",
           "SEMIRINGS", "check_operands", "LaunchPlan", "plan_e",
           "blocks_per_sm", "N_SMS_H100"]

#: semiring name -> the kernel's semiring code
SEMIRINGS = {"sum": 0, "max": 1}
#: largest state count the kernel takes (kMaxStates in the .cu source)
MAX_STATES = 128
#: kernel launches per semiring since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {"sum": 0, "max": 0}

#: shared memory one SM holds on Hopper (bytes)
SMEM_PER_SM = 233_472
#: streaming multiprocessors of an H100 SXM (the plans' default)
N_SMS_H100 = 132

_lib = None
#: (device index, S, semiring) -> (SMs, resident blocks per SM)
_RESIDENT: Dict[Tuple, Tuple[int, int]] = {}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a fused-update kernel is launched for E edges of S states.

    The per-edge split -- ``variant``, ``lanes`` (threads along the
    destination states of one edge), ``xi_split`` (parts of the source
    states, each summed by its own threads) and ``combine`` (the order in
    which partial results meet) -- depends on S alone. ``tile_edges``,
    ``threads``, ``smem_bytes`` and ``grid`` say how edges are packed into
    blocks; ``grid`` follows E.
    """
    variant: str
    lanes: int
    xi_split: int
    combine: str
    tile_edges: int
    threads: int
    smem_bytes: int
    grid: int
    n_tiles: int
    xj_chunk: int = 0        # fused_update_t: destination states per chunk
    vec: int = 1             # fused_update_t: floats per async copy

    def per_edge(self) -> Tuple:
        """The part of the plan that fixes an edge's order of arithmetic."""
        return (self.variant, self.lanes, self.xi_split, self.combine)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Resident blocks an SM can hold by threads (2,048), blocks (32) and
    shared memory (228 KB, 1 KB reserved per block)."""
    return max(1, min(32, 2048 // threads,
                      SMEM_PER_SM // (smem_bytes + 1024)))


def _stage_floats(s: int, tile_edges: int) -> int:
    # stage_floats() in fused_update_e.cu
    return (tile_edges * s * s + 6) // 4 * 4


def plan_e(n_edges: int, n_states: int, n_sms: int = N_SMS_H100,
           resident: int = 0) -> LaunchPlan:
    """Launch plan of ``fused_update_e`` (mirrors ``tile_plan_ok`` and
    ``tile_smem_bytes`` in ``csrc/fused_update_e.cu``).

    - S <= 8, ``"thread"``: one thread per edge, 256-thread blocks, one
      block per 256 edges (the launcher's own grid).
    - S in 9..32, ``"tile"``: next_pow2(S) lanes per edge, each lane one
      destination state, 256/lanes edges per tile; shuffle reductions.
    - S in 33..128, ``"tile"``: 32 lanes x 4 source-state parts, one edge
      per 128-thread tile; parts combined in shared memory, k = 0..3.

    Tiles are staged by two-stage bulk copies; a persistent grid of at most
    ``n_sms`` x ``resident`` blocks walks them -- one wave, so no SM idles
    behind a second. ``resident`` is the kernel's occupancy on the card
    (the wrapper asks the CUDA runtime); 0 takes ``blocks_per_sm``'s
    estimate from threads and shared memory.
    """
    e, s = int(n_edges), int(n_states)
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"fused_update_e takes 1..{MAX_STATES} states, "
                         f"got {s}")
    if s <= 8:
        return LaunchPlan("thread", 1, 1, "xi sequential; xj sequential",
                          256, 256, 0, max(1, -(-e // 256)), -(-e // 256))
    if s <= 32:
        lanes, xi_split, threads = _next_pow2(s), 1, 256
        combine = f"xi sequential; xj xor-shuffle tree of width {lanes}"
    else:
        lanes, xi_split, threads = 32, 4, 128
        combine = ("xi in 4 parts, each sequential, maxima then sums "
                   "combined k=0..3; xj xor-shuffle tree of width 32")
    tile_edges = threads // (lanes * xi_split)
    smem = 16 + 4 * (2 * _stage_floats(s, tile_edges) + 2 * tile_edges * s
                     + (xi_split * s if xi_split > 1 else 0))
    n_tiles = -(-e // tile_edges)
    resident = resident or blocks_per_sm(threads, smem)
    grid = max(1, min(n_tiles, n_sms * resident))
    return LaunchPlan("tile", lanes, xi_split, combine, tile_edges, threads,
                      smem, grid, n_tiles)


def reset_launch_counts() -> None:
    """Set every semiring's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_update_e")
        fn = lib.fused_update_e_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.fused_update_e_occupancy
        occ.argtypes = [ctypes.c_int] * 4
        occ.restype = ctypes.c_int
        _lib = lib
    return _lib.fused_update_e_launch


def _plan(e: int, s: int, semiring: str, device) -> LaunchPlan:
    """``plan_e`` with the card's SM count and the kernel's occupancy, the
    latter asked once per (device, S, semiring)."""
    key = (device.index, s, semiring)
    if key not in _RESIDENT:
        plan = plan_e(e, s)
        blocks = 0
        if plan.variant == "tile":
            blocks = _lib.fused_update_e_occupancy(
                s, SEMIRINGS[semiring], plan.threads, plan.smem_bytes)
            if blocks < 1:
                raise RuntimeError(f"fused_update_e: no block of {plan.threads}"
                                   f" threads and {plan.smem_bytes} bytes of "
                                   f"shared memory fits an SM (S={s})")
        _RESIDENT[key] = (_n_sms(device), blocks)
    n_sms, blocks = _RESIDENT[key]
    return plan_e(e, s, n_sms, blocks)


def _n_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operands(want, device) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` of ``want`` has
    that shape and dtype, lies on ``device`` and is contiguous."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(logpsi, pre, logm, dmask, semiring):
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; "
                         f"expected one of {sorted(SEMIRINGS)}")
    if pre.dim() != 2:
        raise ValueError(f"pre must be (E, S), got {tuple(pre.shape)}")
    e, s = pre.shape
    check_operands({"logpsi": (logpsi, (e, s, s), torch.float32),
                    "pre": (pre, (e, s), torch.float32),
                    "logm": (logm, (e, s), torch.float32),
                    "dmask": (dmask, (e, s), torch.int8)}, pre.device)


def fused_update_e(logpsi: torch.Tensor,   # (E, S, S) f32 [e, x_src, x_dst]
                   pre: torch.Tensor,      # (E, S) f32 source-side belief
                   logm: torch.Tensor,     # (E, S) f32 current messages
                   dmask: torch.Tensor,    # (E, S) int8 valid dst states
                   semiring: str = "sum"):
    """Fused propagate -> normalize -> residual update, edge-major.

    Returns ``(new_logm (E, S) f32, residual (E,) f32)``: ``"sum"`` is
    sum-product (LSE propagate, LSE-normalize), ``"max"`` is max-product
    (max propagate, peak-normalize). Rows with no valid destination state
    give NEG_INF messages and a 0 residual. It calls the dispatcher op
    ``torch.ops.repro_torch.fused_update_e``: CPU tensors run the plain
    torch version; CUDA tensors launch the hand-written kernel on
    ``torch.cuda.current_stream()`` and raise if it cannot build or launch;
    fake tensors (``FakeTensorMode``) get the shapes only.
    """
    _check(logpsi, pre, logm, dmask, semiring)
    dev = pre.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_update_e runs on cpu or cuda, not {dev}")
    return torch.ops.repro_torch.fused_update_e(logpsi, pre, logm, dmask,
                                                semiring)


def _launch(logpsi, pre, logm, dmask, semiring="sum"):
    """The op's CUDA implementation: one launch of the kernel on the
    current stream (operands checked by ``fused_update_e``)."""
    dev = pre.device
    e, s = pre.shape
    if s > MAX_STATES:
        raise ValueError(f"fused_update_e takes at most {MAX_STATES} states, "
                         f"got {s}")
    launch = _kernel()
    if logpsi.data_ptr() % 16:
        raise ValueError("logpsi must start on a 16-byte boundary (the "
                         "kernel stages it by bulk copies)")
    new = torch.empty((e, s), dtype=torch.float32, device=dev)
    resid = torch.empty((e,), dtype=torch.float32, device=dev)
    if e == 0:
        return new, resid
    plan = _plan(e, s, semiring, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(logpsi.data_ptr(), pre.data_ptr(), logm.data_ptr(),
                     dmask.data_ptr(), new.data_ptr(), resid.data_ptr(),
                     e, s, SEMIRINGS[semiring],
                     0 if plan.variant == "thread" else 1, plan.lanes,
                     plan.xi_split, plan.tile_edges, plan.threads,
                     plan.smem_bytes, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"fused_update_e kernel launch failed: cudaError "
                           f"{err} (E={e}, S={s}, semiring={semiring!r})")
    LAUNCHES[semiring] += 1
    return new, resid


def _shapes(logpsi, pre, logm, dmask, semiring="sum"):
    """The op's fake implementation: the results' shapes, nothing run."""
    e, s = pre.shape
    return pre.new_empty((e, s)), pre.new_empty((e,))


#: ``repro_torch::fused_update_e``: the plain version on the CPU, the
#: kernel on CUDA, shapes on fake tensors
_LIB = _dispatch.define(
    "fused_update_e(Tensor logpsi, Tensor pre, Tensor logm, Tensor dmask, "
    "str semiring='sum') -> (Tensor, Tensor)",
    cpu=fused_update_e_ref, cuda=_launch, fake=_shapes)
