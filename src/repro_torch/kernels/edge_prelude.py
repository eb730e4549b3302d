"""The edge prelude of the kernel backends: one vertex-centric CUDA kernel.

Before each fused update, ``"triton"`` and ``"pallas"`` need ``pre``
(E, S), the source-side belief of every directed edge without its reverse
message -- ``messages.edge_prelude``'s result, which that function builds
from a chain of torch gathers. ``csrc/edge_prelude.cu`` builds it in one
launch instead: it walks the vertices, reads each in-edge message row
once, folds the rows into the vertex's sum in registers (in
``fold_in_edges``' order) and writes every out-edge's row from the same
registers, since a vertex's real out-edges are the reverses of its real
in-edges. Rows of padded edges, which no in-edge table lists, are computed
edge by edge in the same launch. Every row is bitwise
``messages.edge_prelude``'s. It replaces no Pallas kernel: the reference's
prelude is plain jnp.

``edge_prelude(pgm, logm)`` is the wrapper. It checks dtypes, shapes,
devices and contiguity, then calls the dispatcher op
``repro_torch::edge_prelude`` (``_dispatch``), which

- for CPU tensors runs the plain torch twin ``edge_prelude_ref``, the same
  vertex walk with index ops;
- for CUDA tensors launches the kernel on the current stream, or raises.
  Nothing falls back to the twin;
- for fake tensors gives the result's shape.

``plan_prelude`` picks, from S and the operands' alignment, how many
floats a lane loads at once and how many lanes share a vertex row;
``LAUNCHES`` counts kernel launches, and only launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.graph import NEG_INF
from repro_torch.kernels import _build, _dispatch
from repro_torch.kernels.triton_update import check_operands

__all__ = ["edge_prelude", "edge_prelude_ref", "LAUNCHES",
           "reset_launch_counts", "MAX_STATES", "plan_prelude"]

#: largest state count the wrapper takes (the kernel's column arithmetic
#: is int; a row of any width is looped over)
MAX_STATES = 1 << 16
#: lanes that share one vertex row at most (one warp)
MAX_LANES = 32
#: kernel launches since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {"edge_prelude": 0}

_lib = None


def reset_launch_counts() -> None:
    """Set ``LAUNCHES["edge_prelude"]`` to 0: a run counts its launches
    from here (one per launch on the card, none on the CPU)."""
    LAUNCHES["edge_prelude"] = 0


def plan_prelude(n_states: int, aligned: int = 16) -> Tuple[int, int]:
    """``(vec, lanes)``: floats a lane moves per load and lanes per vertex
    row. ``vec`` is the widest of 4, 2, 1 that divides S and whose bytes
    (``4 * vec``) divide ``aligned``, the largest power of two that every
    row pointer is aligned to; ``lanes`` is next_pow2(S / vec), at most
    32 (a wider row is looped over): 4 lanes of 16-byte loads at S = 16,
    one lane of 8 bytes at S = 2, 32 lanes of 4 bytes at S = 81."""
    s = int(n_states)
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"edge_prelude takes 1..{MAX_STATES} states, "
                         f"got {s}")
    vec = next(v for v in (4, 2, 1) if s % v == 0 and aligned % (4 * v) == 0)
    lanes = 1 << max(0, (s // vec - 1).bit_length())
    return vec, min(lanes, MAX_LANES)


def _alignment(*addresses: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    for x in addresses:
        while x % a:
            a //= 2
    return a


def edge_prelude_ref(logm, log_psi_v, state_mask, in_edges, in_mask,
                     edge_src, edge_rev, edge_mask):
    """(E, S) ``pre``, the plain torch twin of the kernel: the vertex walk
    with index ops. Each vertex's in-edge rows are gathered once and
    folded in ``fold_in_edges``' order; each real in-edge's row gives the
    row of its reverse, the vertex's out-edge; padded edges' rows are
    computed edge by edge from their sources. Bitwise
    ``messages.edge_prelude``."""
    rows = logm[in_edges]                                     # (V, D, S)
    real = in_mask[:, :, None]
    acc = torch.where(real[:, 0], rows[:, 0], 0.0)
    for d in range(1, rows.shape[1]):
        acc = acc + torch.where(real[:, d], rows[:, d], 0.0)
    base = log_psi_v + acc                                    # (V, S)
    walked = torch.where(state_mask[:, None, :], base[:, None, :] - rows,
                         NEG_INF)
    pre = torch.empty_like(logm)
    pre[edge_rev[in_edges[in_mask]]] = walked[in_mask]
    pad = torch.nonzero(~edge_mask).squeeze(1)
    src = edge_src[pad]
    pre[pad] = torch.where(state_mask[src], base[src] - logm[edge_rev[pad]],
                           NEG_INF)
    return pre


def _check(logm, log_psi_v, state_mask, in_edges, in_mask, edge_src,
           edge_rev, edge_mask):
    if logm.dim() != 2 or log_psi_v.dim() != 2 or in_edges.dim() != 2:
        raise ValueError("logm (E, S), log_psi_v (V, S) and in_edges (V, D) "
                         "must be 2-d")
    e, s = logm.shape
    v, d = in_edges.shape
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"edge_prelude takes 1..{MAX_STATES} states, "
                         f"got {s}")
    if d < 1:
        raise ValueError("in_edges must have at least one column")
    check_operands({"logm": (logm, (e, s), torch.float32),
                    "log_psi_v": (log_psi_v, (v, s), torch.float32),
                    "state_mask": (state_mask, (v, s), torch.bool),
                    "in_edges": (in_edges, (v, d), torch.int32),
                    "in_mask": (in_mask, (v, d), torch.bool),
                    "edge_src": (edge_src, (e,), torch.int32),
                    "edge_rev": (edge_rev, (e,), torch.int32),
                    "edge_mask": (edge_mask, (e,), torch.bool)},
                   logm.device)
    if logm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"edge_prelude runs on cpu or cuda, not "
                         f"{logm.device}")


def edge_prelude(pgm, logm: torch.Tensor) -> torch.Tensor:
    """(E, S) per-edge source-side belief excluding the reverse message,
    bitwise ``messages.edge_prelude(pgm, logm)``, through the dispatcher op
    ``torch.ops.repro_torch.edge_prelude``: CPU tensors run the plain twin
    ``edge_prelude_ref``; CUDA tensors launch the kernel on
    ``torch.cuda.current_stream()`` and raise if it cannot build or
    launch; fake tensors get the shape only. ``logm`` must be float32 and
    contiguous, on the graph's device."""
    ops = (logm, pgm.log_psi_v, pgm.state_mask, pgm.in_edges, pgm.in_mask,
           pgm.edge_src, pgm.edge_rev, pgm.edge_mask)
    _check(*ops)
    return torch.ops.repro_torch.edge_prelude(*ops)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("edge_prelude")
        fn = lib.edge_prelude_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.edge_prelude_launch


def _launch(logm, log_psi_v, state_mask, in_edges, in_mask, edge_src,
            edge_rev, edge_mask):
    """The op's CUDA implementation: one launch on the current stream
    (operands checked by ``edge_prelude``)."""
    dev = logm.device
    e, s = logm.shape
    v, d = in_edges.shape
    launch = _kernel()
    pre = torch.empty((e, s), dtype=torch.float32, device=dev)
    # a lane's VEC floats of a row and VEC bytes of its state mask
    vec, lanes = plan_prelude(s, _alignment(
        logm.data_ptr(), log_psi_v.data_ptr(), pre.data_ptr(),
        4 * state_mask.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(logm.data_ptr(), log_psi_v.data_ptr(),
                     state_mask.data_ptr(), in_edges.data_ptr(),
                     in_mask.data_ptr(), edge_src.data_ptr(),
                     edge_rev.data_ptr(), edge_mask.data_ptr(),
                     pre.data_ptr(), v, e, s, d, vec,
                     lanes.bit_length() - 1, stream)
    if err != 0:
        raise RuntimeError(f"edge_prelude kernel launch failed: cudaError "
                           f"{err} (E={e}, V={v}, S={s}, D={d})")
    LAUNCHES["edge_prelude"] += 1
    return pre


def _shape(logm, *rest):
    """The op's fake implementation: the result's shape, nothing run."""
    return logm.new_empty(logm.shape)


#: ``repro_torch::edge_prelude``: the plain twin on the CPU, the kernel on
#: CUDA, the shape on fake tensors
_LIB = _dispatch.define(
    "edge_prelude(Tensor logm, Tensor log_psi_v, Tensor state_mask, "
    "Tensor in_edges, Tensor in_mask, Tensor edge_src, Tensor edge_rev, "
    "Tensor edge_mask) -> Tensor",
    cpu=edge_prelude_ref, cuda=_launch, fake=_shape)
