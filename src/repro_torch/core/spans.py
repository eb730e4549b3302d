"""Spans of the engine's work, kept in memory, on the profiler's clock.

A span is one stage of a BP call on the host: the call, its chunks, each
loop iteration, and inside an iteration the message update, the
scheduler's select, the commit and every host read of a device value
(``bp.sync``). Each is a plain tuple, in the order of ``FIELDS``:

- ``id``: a number unique in the process;
- ``name``: ``"bp.call"``, ``"bp.step"``, ``"bp.round"``, ...;
- ``start_ns``, ``end_ns``: ``time.time_ns()``, nanoseconds since the Unix
  epoch -- the clock of ``torch.profiler``'s kineto events, so spans lie
  on the same timeline as the device's intervals and the CUDA runtime's
  calls;
- ``parent``: the ``id`` of the span open around it on its thread, or
  None;
- ``thread``: ``threading.get_ident()`` of the thread that ran it;
- ``call``: the id of the ``BPEngine.run`` or ``run_many`` call it belongs
  to, shared by every span of that call; None outside a call (the serving
  pipeline's chunks, which reach ``step`` directly).

The recorder records while a torch profiler is active (torch's own fast
flag, ``torch.autograd.profiler._is_profiler_enabled``) and between
``start()`` and ``stop()``. Off, a span site reads no clock and allocates
nothing: a whole-function site costs one flag test, and the engine's loop
tests the flag once an iteration and guards its sites with that local.
It never reads a device value: no sync, no CUDA event, no ``.item()``.
A finished span is kept as seven scalars in one flat buffer, not as a
tuple: objects the garbage collector tracks, kept by the thousand, would
set off the full collections (over 0.1 s each) that the engine's own
loop never causes. ``spans()`` returns the newest ``CAPACITY`` spans,
oldest first, and leaves them in place. To lay them beside a profile::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run(pgm, generator)
    rows = spans.spans()
    for ev in prof.profiler.kineto_results.events():
        ev.name(), ev.start_ns(), ev.end_ns()   # the spans' nanoseconds

The stages it names are set out in ``repro_torch.core.engine``'s module
docstring.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "thread", "call")
#: spans kept: the newest this many
CAPACITY = 1 << 20

#: each span's ``FIELDS``, flat: ints, a str and Nones, none GC-tracked
_buffer: collections.deque = collections.deque(
    maxlen=len(FIELDS) * CAPACITY)
_ids = itertools.count()
_call_ids = itertools.count(1)
_local = threading.local()
_started = False


def recording() -> bool:
    """Whether span sites record now: a torch profiler is active, or
    ``start()`` was called and ``stop()`` not since."""
    return _profiler._is_profiler_enabled or _started


def start() -> None:
    """Record spans without a profiler, until ``stop()``."""
    global _started
    _started = True


def stop() -> None:
    """End what ``start()`` began (a profiler still records)."""
    global _started
    _started = False


def spans() -> list:
    """The kept spans, oldest first, as tuples of ``FIELDS``; the buffer
    keeps them."""
    flat, n = list(_buffer), len(FIELDS)
    return [tuple(flat[i:i + n]) for i in range(0, len(flat), n)]


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def begin(name: str, *, call: bool = False):
    """Open span ``name`` on this thread and return its handle for
    ``end``. With ``call=True`` it opens a new call id, unless a span of a
    call is already open on this thread: then it returns None (a call
    inside a call is part of the outer one). Callers check ``recording()``
    first."""
    stack = _stack()
    top = stack[-1] if stack else None
    outer = top[5] if top else None
    if call:
        if outer is not None:
            return None
        outer = next(_call_ids)
    rec = [next(_ids), name, time.time_ns(), top[0] if top else None,
           threading.get_ident(), outer]
    stack.append(rec)
    return rec


def end(rec) -> None:
    """Close the span ``begin`` opened (and any left open inside it by an
    exception)."""
    if rec is None:
        return
    t = time.time_ns()
    stack = _stack()
    while stack and stack.pop() is not rec:
        pass
    # one C call, so another thread's span cannot interleave
    _buffer.extend((rec[0], rec[1], rec[2], t, rec[3], rec[4], rec[5]))


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = begin(self.name)

    def __exit__(self, *exc):
        end(self.rec)


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records the block as a span while
    ``recording()``."""
    return _Span(name) if recording() else _OFF


def traced(name: str, *, call: bool = False):
    """Decorator: each call of the function is a span ``name`` while
    ``recording()``; with ``call=True`` the outermost such call on a thread
    also opens a call id (``begin``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            rec = begin(name, call=call)
            try:
                return fn(*args, **kwargs)
            finally:
                end(rec)
        return run
    return wrap
