"""Op-level flop and byte counter: the port's counterpart of
``repro.roofline.jaxpr_cost``.

The reference walks a jaxpr; the port has no jaxpr, so it watches the ops
that run. ``OpCounter`` is a ``TorchDispatchMode``: every aten op that a
function dispatches passes through it with its operands, and it charges the
op by the reference's rules. (The module is not called ``jaxpr_cost``: no
jaxpr is read here.) What runs is counted as it runs, so a Python loop over
per-layer modules counts each layer, as the reference's ``scan`` body times
its length does, and a recomputed (``torch.utils.checkpoint``) forward is
counted where the backward recomputes it, as the reference counts a
``remat`` body. A BP ``while`` loop is counted per round by its caller
(``kernel_model.round_cost``), as the reference's ``while_trips`` is.

Rules, per op (one flop per output element for each arithmetic op, FMA = 2):

  dot      ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``mv``,
           ``addmv``, ``dot`` (what ``matmul``, ``linear`` and ``einsum``
           become): 2 * batch * M * N * K flops; bytes lhs + rhs + out. The
           bias add of the ``add*`` forms is an elementwise op beside it,
           as jax traces it.
  conv     ``convolution``: 2 * out_elems * kernel_elems / out_channels
           (the reference's ``_conv_cost``), bytes in + out;
           ``convolution_backward``: the same for each gradient it makes.
  reduce   ``sum``, ``mean``, ``amax``, ``amin``, ``max``/``min`` over a
           dimension, ``prod``, ``any``, ``all``, ``argmax``, ``argmin``,
           ``logsumexp``, ``var``, ``std``, ``norm``, ``_softmax``,
           ``_log_softmax`` and their backward ops: one flop per input
           element, bytes in + out.
  memory   ``gather``, ``index``, ``index_select``, ``scatter*``,
           ``index_put``, ``index_add``, ``index_copy``, ``embedding`` and
           its backward, ``sort``, ``topk``, ``cumsum``, ``logcumsumexp``,
           ``cummax``, ``flip``, ``arange``, ``repeat``,
           ``repeat_interleave``, and the copies ``clone``, ``copy_``,
           ``_to_copy``: bytes in + out, no flops.
  fused    the port's kernels, bound as dispatcher ops
           (``repro_torch::fused_update_e``, ``fused_update_t``): each
           operand read once and each result written once, and the flops of
           ``kernel_model.fused_update_cost`` -- the fused-kernel contract
           the reference charges at a ``pallas_call``.
  view     views (``view``, ``transpose``, ``expand``, ``slice``,
           ``detach``, ...), allocations (``empty*``) and host reads:
           nothing.
  collective  ``torch.distributed``'s ops: nothing here (their bytes are
           counted by ``dist.comm``).
  elementwise  every other op: one flop per output element, 0 bytes (taken
           to be fused into a producer).

Where aten and the jaxpr differ, and so the two counts do:

- softmax: aten's ``_softmax`` is one op, charged as one reduction; jax
  traces ``reduce_max``, ``sub``, ``exp``, ``reduce_sum`` and ``div`` (two
  reductions and three elementwise ops). ``logsumexp`` likewise.
- transposes and broadcasts: views here, free; jax's ``transpose`` and
  ``broadcast_in_dim`` are memory primitives, charged in + out. A torch
  transpose moves bytes only where a copy (``clone``, ``contiguous``)
  follows it, and is charged there.
- ``reshape`` of a non-contiguous tensor and ``matmul``'s broadcasts copy
  (``clone``/``_unsafe_view``), which jax's ``reshape`` does not.
- ``cat``, ``stack`` and ``constant_pad_nd`` are elementwise here, as
  jax's ``concatenate`` and ``pad`` are there.
- factories (``zeros``, ``full``, ``fill_``) are elementwise; jax builds
  them by ``broadcast_in_dim``, a memory primitive.
- in-place ops (``add_``, ``copy_``) are charged as their out-of-place
  forms; jax has no in-place op.
- ``embedding`` is a memory op (jax: ``gather``); its backward
  ``embedding_dense_backward`` too (jax: ``scatter-add``).
- ``ragged_dot`` (the reference's MoE): jax's walker has no rule for it and
  charges it one flop per output element; the port's MoE runs plain
  products per expert group, counted as dots.
- random draws (``uniform_``, ``normal_``, ``randint``) are one elementwise
  op; jax's threefry is many.

``OpCounter(live=True)`` also follows the bytes held by tensors: each
storage an op makes is counted from its first output until it is freed,
so ``peak`` is the largest sum held at once (the storages of the tensors
given to ``hold`` included). On fake tensors (``FakeTensorMode``) nothing
is allocated and the same is counted, which is how the dry run sizes a
step (``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

__all__ = ["Cost", "CLASSES", "OpCounter", "LiveBytes", "op_cost",
           "trace_cost", "fake_tensors", "tensors_of"]


@dataclasses.dataclass(frozen=True)
class Cost:
    """Flops and bytes (the reference's ``jaxpr_cost.Cost`` fields)."""
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def __sub__(self, o: "Cost") -> "Cost":
        return Cost(self.flops - o.flops, self.bytes - o.bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__

    @property
    def intensity(self) -> float:
        """Flops per byte."""
        return self.flops / self.bytes if self.bytes else 0.0


#: the classes an op is charged under (``OpCounter.by_class``)
CLASSES = ("dot", "conv", "reduce", "memory", "fused", "elementwise", "view",
           "collective")

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
         "vdot", "_addmm_activation"}
_CONVS = {"convolution", "_convolution", "convolution_overrideable"}
_REDUCES = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
            "all", "argmax", "argmin", "logsumexp", "var", "var_mean", "std",
            "std_mean", "norm", "linalg_vector_norm", "nansum", "aminmax",
            "count_nonzero", "_softmax", "_log_softmax",
            "_softmax_backward_data", "_log_softmax_backward_data"}
_MEMORY = {"gather", "index", "_unsafe_index", "index_select", "scatter",
           "scatter_add", "scatter_reduce", "index_put", "_index_put_impl",
           "_unsafe_index_put", "index_add", "index_copy", "index_fill",
           "masked_scatter", "embedding", "embedding_dense_backward", "sort",
           "topk", "cumsum", "logcumsumexp", "cummax", "cummin", "flip",
           "arange", "repeat", "repeat_interleave", "clone", "copy", "copy_",
           "_to_copy", "take", "take_along_dim"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense",
         "resize_", "set_", "alias", "record_stream", "_assert_async",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_has_compatible_shallow_copy_type", "equal",
         "is_nonzero"}


def tensors_of(tree) -> list:
    """The tensors of ``tree``: nested dicts, lists, tuples and
    dataclasses (a ``TrainState``), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tensors_of([getattr(tree, f.name)
                           for f in dataclasses.fields(tree)])
    if isinstance(tree, dict):
        return tensors_of(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    return []


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _io_bytes(args, out) -> float:
    return sum(_nbytes(t) for t in tensors_of(args)) + \
        sum(_nbytes(t) for t in tensors_of(out))


def _prod(xs: Iterable[int]) -> float:
    return float(math.prod(int(x) for x in xs))


def _dot(name: str, args, out) -> Tuple[Cost, float]:
    """(the dot's cost, the elementwise flops of a fused bias add)."""
    if name in ("addmm", "baddbmm", "addbmm", "addmv", "_addmm_activation"):
        bias, a, b = args[0], args[1], args[2]
    else:
        bias, a, b = None, args[0], args[1]
    if name in ("bmm", "baddbmm"):          # (B, M, K) @ (B, K, N)
        flops = 2.0 * _prod(a.shape) * b.shape[-1]
    elif name == "addbmm":                  # sum over B of (M, K) @ (K, N)
        flops = 2.0 * _prod(a.shape) * b.shape[-1]
    elif name in ("mv", "addmv", "dot", "vdot"):
        flops = 2.0 * _prod(a.shape)
    else:                                   # (M, K) @ (K, N)
        flops = 2.0 * _prod(a.shape) * b.shape[-1]
    byts = _nbytes(a) + _nbytes(b) + sum(_nbytes(t) for t in tensors_of(out))
    extra = _prod(tensors_of(out)[0].shape) if bias is not None else 0.0
    return Cost(flops, byts), extra


def _conv(args, out) -> Cost:
    weight = args[1]
    per_out = _prod(weight.shape[1:])       # (O, I/groups, *kernel)
    outs = tensors_of(out)
    return Cost(2.0 * _prod(outs[0].shape) * per_out,
                _io_bytes(args[:3], outs))


def _conv_backward(args, out) -> Cost:
    grad_out, weight = args[0], args[2]
    made = sum(1 for t in tensors_of(out)[:2])
    per = 2.0 * _prod(grad_out.shape) * _prod(weight.shape[1:])
    return Cost(per * made, _io_bytes(args[:3], out))


def _fused(name: str, args) -> Cost:
    from repro_torch.roofline.kernel_model import fused_update_cost
    if name == "fused_update_e":             # (E, S, S), (E, S), ...
        e, s = args[1].shape
        semiring = args[4] if len(args) > 4 else "sum"
    else:                                    # (S, S, E), (S, E), ...
        s, e = args[1].shape
        semiring = "sum"
    model = fused_update_cost(e, s, semiring=semiring)
    # each operand read once, (new (E, S) f32, resid (E,) f32) written once
    byts = sum(_nbytes(t) for t in args[:4]) + 4.0 * (e * s + e)
    return Cost(model.flops, byts)


def charge(func, args, kwargs, out) -> Dict[str, Cost]:
    """``{class: cost}`` of one dispatched op (see the module docstring)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and name != "copy_":      # in place: as out of it
        name = name[:-1]
    ns = func.namespace
    if ns == "repro_torch":
        return {"fused": _fused(name, args)}
    if ns in ("c10d", "_c10d_functional", "_dtensor", "c10d_functional"):
        return {"collective": Cost()}
    if func.is_view or name in _FREE:
        return {"view": Cost()}
    if name in _DOTS:
        dot, extra = _dot(name, args, out)
        return {"dot": dot, "elementwise": Cost(extra, 0.0)}
    if name in _CONVS:
        return {"conv": _conv(args, out)}
    if name == "convolution_backward":
        return {"conv": _conv_backward(args, out)}
    outs = tensors_of(out)
    if name in ("max", "min") and len(args) > 1 and \
            isinstance(args[1], torch.Tensor):
        name = "maximum"                    # binary: elementwise
    if name in _REDUCES:
        return {"reduce": Cost(sum(float(t.numel()) for t in tensors_of(
            args[:1])), _io_bytes(args[:1], outs))}
    if name in _MEMORY:
        ins = [t for t in tensors_of(args) + tensors_of(kwargs)]
        if name == "copy_":                 # dst, src: the dst is written
            ins = ins[1:2]
        return {"memory": Cost(0.0, sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))}
    return {"elementwise": Cost(sum(float(t.numel()) for t in outs), 0.0)}


class LiveBytes:
    """Bytes held by tensors' storages, now and at most, from the first
    output that makes a storage to its release."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors that are not counted
        yet; returns the bytes added."""
        added = 0
        for t in tensors_of(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            n = int(st.nbytes())
            self._held[key] = n
            self.now += n
            added += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.now)
        return added

    def _free(self, key: int) -> None:
        self.now -= self._held.pop(key, 0)


class OpCounter(TorchDispatchMode):
    """Count every op dispatched inside ``with OpCounter() as c:``:
    ``c.cost`` is the total, ``c.by_class`` the total by class (``CLASSES``)
    and ``c.calls`` the calls by op name. With ``live=True``, ``c.live``
    (``LiveBytes``) follows the bytes tensors hold; ``c.hold(tree)`` counts
    tensors made before (parameters, inputs)."""

    def __init__(self, *, live: bool = False):
        super().__init__()
        self.by_class: Dict[str, Cost] = {c: Cost() for c in CLASSES}
        self.calls: Counter = Counter()
        self.live = LiveBytes() if live else None

    @property
    def cost(self) -> Cost:
        total = Cost()
        for c in self.by_class.values():
            total = total + c
        return total

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as held; returns the
        bytes added."""
        return self.live.track(tree) if self.live is not None else 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for cls, c in charge(func, args, kwargs, out).items():
            self.by_class[cls] = self.by_class[cls] + c
        self.calls[str(func.overloadpacket)] += 1
        if self.live is not None:
            self.live.track(out)
        return out


def op_cost(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` and count its ops (see the module
    docstring). The tensors may be real or fake."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[1], torch.dtype)


def faketensors_of(tree, mode, device="cpu"):
    """``tree`` with each ``(shape, dtype)`` spec and each meta tensor
    replaced by an empty tensor of ``mode`` (a ``FakeTensorMode``) on
    ``device``; other leaves kept."""
    def make(x):
        if _is_spec(x):
            shape, dtype = x
        elif isinstance(x, torch.Tensor) and x.device.type == "meta":
            shape, dtype = x.shape, x.dtype
        else:
            return x
        with mode:
            return torch.empty(tuple(shape), dtype=dtype, device=device)
    return tree_map(make, tree, is_leaf=_is_spec)


def trace_cost(fn, *specs, device="cpu", **kwargs) -> Cost:
    """``op_cost`` on fake tensors: each ``(shape, dtype)`` spec or meta
    tensor of ``specs`` becomes a fake tensor on ``device``, so nothing is
    allocated or computed (the reference's ``trace_cost`` on
    ``ShapeDtypeStruct`` arguments)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = faketensors_of(specs, mode, device)
    with mode:
        return op_cost(fn, *args, **kwargs)
