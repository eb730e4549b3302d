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
gathered, passed from rank to rank or broadcast, never reduced: a float
``all_reduce`` adds in an order the library picks, and the callers combine
parts in rank order instead (``rank_order_sum``, or the sharded BP's chain
fold, which passes a running table up the ranks with ``send_next``/
``recv_prev`` and ``broadcast``s the last rank's).
``all_reduce_count`` sums integers, which is exact in any order, and
``rank_order_sum`` adds gathered float parts in rank order, so every rank of
the group holds bitwise the same sum.

Gradients. ``rank_order_sum``, ``all_gather_cat`` and ``enter`` are
``torch.autograd.Function``s, so a tensor-parallel or ZeRO-3 forward
differentiates through its collectives. Every rank of the group runs the
same global function, and a replicated tensor carries the same gradient on
every rank:

- ``rank_order_sum``: the backward is the identity (each rank's part gets
  the sum's whole gradient);
- ``all_gather_cat``: the backward takes this rank's slice of the gradient
  (``grad="slice"``, the consumers replicated), or the rank-order sum of
  every rank's slice (``grad="sum"``, the consumers partial: ZeRO-3's
  gathered weights, whose gradient is a reduce-scatter);
- ``enter``: the identity, for a replicated tensor that feeds a rank-local
  computation (column-parallel weights, or a replicated weight applied to
  the rank's heads); its backward is the rank-order sum of the ranks'
  partial gradients.

The host staging of a gloo group runs inside ``forward`` and ``backward``.
Every backward sum runs in rank order, so the ranks' gradients of a
replicated tensor are bitwise equal.

``STATS["collectives"]`` counts the calls of the collectives below, those
of the backward passes included.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["STATS", "reset_stats", "transport", "all_gather",
           "all_gather_into", "all_gather_cat", "rank_order_sum", "enter",
           "all_reduce_count", "exchange", "send_next", "recv_prev",
           "broadcast"]

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


def _add_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (``t`` splits evenly over
    the group)."""
    size = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * size, size)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``,
    added in rank order in float32 (at least) and rounded once to ``t``'s
    dtype: every rank sends block ``s`` of its ``t`` to rank ``s`` (one
    all-to-all), so each rank moves one tensor's worth of bytes."""
    n = dist.get_world_size(group)
    blocks = torch.stack(torch.chunk(t, n, dim=dim)).contiguous()
    got = torch.empty_like(blocks)
    _host_staged(group, [blocks], [got], lambda i, o: dist.all_to_all_single(
        o[0], i[0], group=group))
    acc = torch.promote_types(t.dtype, torch.float32)
    return _add_in_order([b.to(acc) for b in got.unbind(0)]).to(t.dtype)


class _RankOrderSum(torch.autograd.Function):
    """Forward: the rank-order sum. Backward: the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return _add_in_order(all_gather(t.contiguous(), group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherCat(torch.autograd.Function):
    """Forward: every rank's block concatenated along ``dim``. Backward:
    this rank's slice of the gradient (``"slice"``), or of the rank-order
    sum of every rank's gradient (``"sum"``)."""

    @staticmethod
    def forward(ctx, t, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return torch.cat(all_gather(t.contiguous(), group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _slice(g, ctx.dim, ctx.group), None, None, None


class _Enter(torch.autograd.Function):
    """Forward: the identity. Backward: the rank-order sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _add_in_order(all_gather(grad.contiguous(), ctx.group)), None


def all_gather_cat(t: torch.Tensor, dim: int, group,
                   grad: str = "slice") -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (one
    gather). Its backward gives this rank the slice of the gradient
    (``grad="slice"``: every rank computed the same gradient) or the
    rank-order sum of every rank's slice (``grad="sum"``: each rank's
    gradient is a partial one)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', got {grad!r}")
    return _GatherCat.apply(t, dim % t.dim(), group, grad)


def rank_order_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order after one gather:
    the same bits on every rank of the group, whatever the transport. Its
    backward is the identity."""
    return _RankOrderSum.apply(t, group)


def enter(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, replicated over the group, entering a computation each
    rank does on its own share (Megatron's "copy to the model-parallel
    region"); the backward sums the ranks' gradients in rank order."""
    return _Enter.apply(t, group)


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


def send_next(t: torch.Tensor, group) -> None:
    """Pass ``t`` to the next rank of ``group`` (rank ``r`` to ``r + 1``;
    nothing on the last rank), which takes it with ``recv_prev``."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if rank + 1 < n:
        exchange([(rank + 1, t)], [], group)


def recv_prev(buf: torch.Tensor, group) -> torch.Tensor:
    """Fill ``buf`` with what the previous rank of ``group`` passed with
    ``send_next`` (nothing on rank 0); returns ``buf``."""
    rank = dist.get_rank(group)
    if rank > 0:
        exchange([], [(rank - 1, buf)], group)
    return buf


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of rank ``src`` of ``group`` written into ``t`` on every rank,
    in place; returns ``t``. Host-staged on a gloo group with CUDA tensors:
    ``src`` stages its tensor out, the others stage theirs in."""
    root = dist.get_global_rank(group, src)
    if dist.get_rank(group) == src:
        _host_staged(group, [t], [], lambda i, o: dist.broadcast(
            i[0], root, group=group))
    else:
        _host_staged(group, [], [t], lambda i, o: dist.broadcast(
            o[0], root, group=group))
    return t
