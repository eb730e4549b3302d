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
of the backward passes included. ``STATS["bytes/<kind>"]`` counts their
bytes by the kind of collective an XLA program would show, by the
reference's conventions (``repro.roofline.analysis.collective_bytes``):
the result's bytes on this rank -- ``all-gather`` (``all_gather``,
``all_gather_into``, ``all_gather_cat``, and ``rank_order_sum``, a gather
then an add), ``all-reduce`` at twice its result (``all_reduce_count``),
``all-to-all`` (the reduce-scatter of ``all_gather_cat(grad="sum")``'s
backward, which moves one tensor's blocks; so ``reduce-scatter`` stays 0),
``collective-permute`` (``exchange``, ``send_next``, ``recv_prev``: the
larger of what the rank sends and receives, the operand every device of
an XLA permute holds) and ``collective-broadcast`` (``broadcast``: the
tensor). ``GROUP_BYTES`` holds the same bytes by the global ranks of the
group they ran on, which ``roofline.analysis`` charges at the speed of the
links those ranks share.

Host data. Two more channels carry small host objects (pickled; ints,
floats, short id lists, finished records), never tensors a computation
reads:

- ``publish``: one object from rank 0 of a gloo group to every rank of it
  (the decisions a sharded serving pipeline's leader takes for its group).
  It runs on a gloo group on the mesh's ranks (``BPMesh.host_group``: the
  mesh's own group under gloo, one beside it under NCCL), so nothing is
  staged through the card and the card is never synchronized for a
  decision. ``STATS["decisions"]``,
  ``["decision_bytes"]`` and ``["decision_ms"]`` count the calls, their
  payload bytes and their host milliseconds.
- ``Channel``: point-to-point messages between ranks of a gloo group (the
  router's front and the leaders of its replicas). A send completes once
  the peer has posted the matching receive; a receive from no named peer
  takes the next message of any.

Every wait of both raises after the world's timeout (``world_timeout``):
a rank that diverges fails, it does not hang. ``group_of`` makes each such
group once per world.
"""

from __future__ import annotations

import datetime
import pickle
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["STATS", "KINDS", "GROUP_BYTES", "reset_stats", "transport", "all_gather",
           "all_gather_into", "all_gather_cat", "rank_order_sum", "enter",
           "all_reduce_count", "exchange", "send_next", "recv_prev",
           "broadcast", "publish", "Channel", "world_timeout", "group_of"]

#: the kinds of collective whose bytes ``STATS`` counts
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "collective-broadcast")

#: collective calls and host-staged bytes, and the decision broadcasts
#: (``publish``: calls, payload bytes, host milliseconds), and the
#: collectives' bytes by kind (``"bytes/<kind>"``), since the last
#: ``reset_stats``
STATS: Dict[str, float] = {"collectives": 0, "staged_bytes": 0,
                           "decisions": 0, "decision_bytes": 0,
                           "decision_ms": 0.0,
                           **{f"bytes/{k}": 0 for k in KINDS}}

#: the collectives' bytes by the global ranks of their group (a tuple)
GROUP_BYTES: Dict[Tuple[int, ...], int] = {}

# all_gather_into_tensor under the name newer torch releases give it
_GATHER_INTO = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def reset_stats() -> None:
    """Zero ``STATS`` and empty ``GROUP_BYTES``."""
    for k in STATS:
        STATS[k] = 0.0 if k == "decision_ms" else 0
    GROUP_BYTES.clear()


def world_timeout() -> datetime.timedelta:
    """The default process group's timeout, as the caller initialized it
    (torch's default of 30 minutes where the backend does not say): the
    timeout of every group and wait this package makes beside a mesh."""
    backend = dist.get_backend()
    device = torch.device("cuda" if backend == "nccl" else "cpu")
    try:
        pg = dist.distributed_c10d._get_default_group()
        return pg._get_backend(device).options._timeout
    except (AttributeError, RuntimeError):
        return datetime.timedelta(minutes=30)


# (backend, ranks, tag) -> process group, for the world in _GROUPS_OF
_GROUPS: Dict[tuple, Any] = {}
_GROUPS_OF: List[Any] = [None]


def group_of(ranks: Sequence[int], backend: str | None = None,
             tag: str | None = None):
    """The process group on the ascending global ``ranks`` over
    ``backend`` (the world's when ``None``): the world's own group where
    that is the same ranks and backend and no ``tag`` is given, else one
    ``new_group`` (with ``world_timeout()``), made the first time it is
    asked for and reused for the rest of the world's life. A group that
    ``new_group`` makes needs every rank of the world, members or not, so
    every rank asks for the same groups in the same order. ``tag`` keeps a
    group apart from any other on the same ranks (a channel that another
    thread drives)."""
    world = dist.group.WORLD
    if _GROUPS_OF[0] is not world:      # a new world: the old groups died
        _GROUPS.clear()
        _GROUPS_OF[0] = world
    ranks = tuple(int(r) for r in ranks)
    backend = backend or dist.get_backend()
    if tag is None and backend == dist.get_backend() and \
            ranks == tuple(range(dist.get_world_size())):
        return world
    key = (backend, ranks, tag)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks), backend=backend,
                                      timeout=world_timeout())
    return _GROUPS[key]


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


#: process group -> its global ranks (asked once per group)
_RANKS: Dict[Any, Tuple[int, ...]] = {}


def _count(group, kind: str, inputs, outputs) -> None:
    """Add one collective's bytes of ``kind`` (see the module docstring)
    to ``STATS`` and ``GROUP_BYTES``."""
    if kind in ("collective-permute", "collective-broadcast"):
        n = max(_nbytes(inputs), _nbytes(outputs))
    else:
        n = _nbytes(outputs) * (2 if kind == "all-reduce" else 1)
    STATS[f"bytes/{kind}"] += n
    if group not in _RANKS:
        _RANKS[group] = tuple(dist.get_process_group_ranks(group))
    ranks = _RANKS[group]
    GROUP_BYTES[ranks] = GROUP_BYTES.get(ranks, 0) + n


def _host_staged(group, inputs: Sequence[torch.Tensor],
                 outputs: Sequence[torch.Tensor],
                 op: Callable[[List[torch.Tensor], List[torch.Tensor]],
                              None], kind: str) -> None:
    """Run ``op(inputs, outputs)``, the collective (of ``kind``, one of
    ``KINDS``), on the group's own transport. On a gloo group with CUDA
    tensors, ``op`` runs on host copies of ``inputs`` into host buffers
    shaped like ``outputs``, which are then copied back into ``outputs``;
    the bytes of both copies are counted."""
    STATS["collectives"] += 1
    _count(group, kind, inputs, outputs)
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
                 lambda i, o: dist.all_gather(o, i[0], group=group),
                 "all-gather")
    return outs


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Every rank's ``t`` written into ``out`` along its first axis, in
    rank order (``out`` holds world-size times ``t``'s rows)."""
    _host_staged(group, [t], [out],
                 lambda i, o: _GATHER_INTO(o[0], i[0], group=group),
                 "all-gather")


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
        o[0], i[0], group=group), "all-to-all")
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
    _host_staged(group, [t], [t], op, "all-reduce")
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
    _host_staged(group, [t for _, t in sends], [t for _, t in recvs], op,
                 "collective-permute")


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
            i[0], root, group=group), "collective-broadcast")
    else:
        _host_staged(group, [], [t], lambda i, o: dist.broadcast(
            o[0], root, group=group), "collective-broadcast")
    return t


# ------------------------------------------------------------ host data --

def _pickled(obj) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(
        obj, protocol=pickle.HIGHEST_PROTOCOL)), dtype=torch.uint8)


def _unpickled(buf: torch.Tensor):
    return pickle.loads(buf.numpy().tobytes())


def publish(obj: Any, group) -> Any:
    """``obj`` of rank 0 of ``group`` (a gloo group), on every rank of it:
    rank 0 passes the object, the others anything (``None``) and get rank
    0's back. Two broadcasts, its size and its pickle; counted in
    ``STATS`` as one decision."""
    t0 = time.perf_counter()
    root = dist.get_global_rank(group, 0)
    size = torch.zeros(1, dtype=torch.int64)
    if dist.get_rank(group) == 0:
        buf = _pickled(obj)
        size[0] = buf.numel()
        dist.broadcast(size, root, group=group)
        dist.broadcast(buf, root, group=group)
    else:
        dist.broadcast(size, root, group=group)
        buf = torch.empty(int(size[0]), dtype=torch.uint8)
        dist.broadcast(buf, root, group=group)
        obj = _unpickled(buf)
    STATS["decisions"] += 1
    STATS["decision_bytes"] += int(size[0])
    STATS["decision_ms"] += (time.perf_counter() - t0) * 1e3
    return obj


class Channel:
    """Point-to-point messages of picklable host objects between ranks of
    a gloo ``group`` (peers named by global rank). A message is a header
    (sender, size) and its pickle, under two tags; ``recv()`` with no peer
    takes the next header of any. One thread of a process uses a channel
    at a time (gloo takes one operation per group at once); each wait
    raises after ``world_timeout()``."""

    HEAD, BODY = 1, 2

    def __init__(self, group):
        self.group = group
        self.timeout = world_timeout()

    def send(self, obj: Any, dst: int) -> None:
        """Send ``obj`` to global rank ``dst``; returns once it took it."""
        body = _pickled(obj)
        head = torch.tensor([dist.get_rank(), body.numel()],
                            dtype=torch.int64)
        for t, tag in ((head, self.HEAD), (body, self.BODY)):
            dist.isend(t, dst, group=self.group, tag=tag).wait(self.timeout)

    def recv(self, src: "int | None" = None) -> Tuple[int, Any]:
        """``(sender's global rank, object)``: the next message from
        ``src``, or from any peer when ``src`` is ``None``."""
        head = torch.empty(2, dtype=torch.int64)
        dist.irecv(head, src, group=self.group,
                   tag=self.HEAD).wait(self.timeout)
        src = int(head[0])
        body = torch.empty(int(head[1]), dtype=torch.uint8)
        dist.irecv(body, src, group=self.group,
                   tag=self.BODY).wait(self.timeout)
        return src, _unpickled(body)
