"""The collectives of the multi-device paths, over ``torch.distributed``.

Every collective of ``repro_torch.dist`` goes through this module, on the
process group of the caller's mesh, initialized as the caller chose. The
transport follows from that group's backend and the tensors' device, and
from nothing else:

- ``"nccl"``: CUDA tensors, the collective runs on the card;
- ``"gloo"``: CPU tensors, the collective runs on the host;
- ``"gloo, host-staged"``: CUDA tensors on a gloo group -- several ranks
  sharing one card, which NCCL refuses. gloo has no CUDA ``all_gather``,
  ``send`` or ``recv``, so ``_host_staged`` copies the inputs to the host,
  runs the collective there and copies the outputs back to the card.
  ``STATS["staged_bytes"]`` counts what it copies, both ways. Only the
  exchange is staged: every update still runs on the card.

No backend is ever swapped for another. Floating-point data is only ever
gathered, never reduced: a float ``all_reduce`` adds in an order the library
picks, and the callers combine gathered parts in rank order instead.
``all_reduce_count`` sums integers, which is exact in any order, and
``rank_order_sum`` adds gathered float parts in rank order, so every rank of
the group holds bitwise the same sum.

``STATS["collectives"]`` counts the calls of the functions below.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["STATS", "reset_stats", "transport", "all_gather",
           "all_gather_into", "all_gather_cat", "rank_order_sum",
           "all_reduce_count", "exchange"]

#: collective calls and host-staged bytes since the last ``reset_stats``
STATS: Dict[str, int] = {"collectives": 0, "staged_bytes": 0}

# all_gather_into_tensor under the name newer torch releases give it
_GATHER_INTO = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def reset_stats() -> None:
    """Zero ``STATS``."""
    for k in STATS:
        STATS[k] = 0


def transport(group, device) -> str:
    """How collectives of ``group`` move tensors on ``device``: the group's
    backend (``"nccl"``, ``"gloo"``), or ``"gloo, host-staged"`` for CUDA
    tensors on a gloo group."""
    backend = str(dist.get_backend(group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo, host-staged"
    return backend


def _nbytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _host_staged(group, inputs: Sequence[torch.Tensor],
                 outputs: Sequence[torch.Tensor],
                 op: Callable[[List[torch.Tensor], List[torch.Tensor]],
                              None]) -> None:
    """Run ``op(inputs, outputs)``, the collective, on the group's own
    transport. On a gloo group with CUDA tensors, ``op`` runs on host
    copies of ``inputs`` into host buffers shaped like ``outputs``, which
    are then copied back into ``outputs``; the bytes of both copies are
    counted."""
    STATS["collectives"] += 1
    tensors = list(inputs) + list(outputs)
    if not tensors or transport(group, tensors[0].device) != \
            "gloo, host-staged":
        op(list(inputs), list(outputs))
        return
    h_in = [t.cpu() for t in inputs]
    h_out = [torch.empty(t.shape, dtype=t.dtype) for t in outputs]
    op(h_in, h_out)
    for dev_t, host_t in zip(outputs, h_out):
        dev_t.copy_(host_t)
    STATS["staged_bytes"] += _nbytes(h_in) + _nbytes(h_out)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order (a list of new tensors)."""
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _host_staged(group, [t], outs,
                 lambda i, o: dist.all_gather(o, i[0], group=group))
    return outs


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Every rank's ``t`` written into ``out`` along its first axis, in
    rank order (``out`` holds world-size times ``t``'s rows)."""
    _host_staged(group, [t], [out],
                 lambda i, o: _GATHER_INTO(o[0], i[0], group=group))


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (one
    gather)."""
    return torch.cat(all_gather(t.contiguous(), group), dim=dim)


def rank_order_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order after one gather:
    the same bits on every rank of the group, whatever the transport."""
    parts = all_gather(t.contiguous(), group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def all_reduce_count(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of an integer tensor over the group, in place; returns
    ``t``. Floats are refused (see the module docstring)."""
    if t.is_floating_point():
        raise TypeError("all_reduce_count sums integers only; gather float "
                        "parts and add them in rank order")

    def op(i, o):
        o[0].copy_(i[0])
        dist.all_reduce(o[0], group=group)
    _host_staged(group, [t], [t], op)
    return t


def exchange(sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]], group) -> None:
    """Point-to-point: send each ``(peer, tensor)`` of ``sends`` and
    receive each ``(peer, buffer)`` of ``recvs`` (peers are ranks of
    ``group``), all posted together by ``batch_isend_irecv`` and waited
    for."""
    if not sends and not recvs:
        return

    def op(i, o):
        peer = lambda r: dist.get_global_rank(group, r)   # noqa: E731
        ops = [dist.P2POp(dist.isend, x, peer(r), group)
               for (r, _), x in zip(sends, i)]
        ops += [dist.P2POp(dist.irecv, x, peer(r), group)
                for (r, _), x in zip(recvs, o)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _host_staged(group, [t for _, t in sends], [t for _, t in recvs], op)
