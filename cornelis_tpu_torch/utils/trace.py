"""Spans inside the program, on the profiler's clock; off by default.

    from cornelis_tpu_torch.utils import trace

    with trace.collect() as spans:          # or trace.enable() ... trace.disable()
        render_scene(scene, options)
    for s in spans:
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs)

`span(name)` is a context. Off, it is one flag test returning a shared
no-op context: no allocation, no clock reading, no profiler range, no
device synchronisation. On, a span records its name (every name is
`ct.`-prefixed, apart from the benchmark's and the user's own ranges),
its start and end in `time.time_ns()` nanoseconds, the id of its parent
span, its request id and a few integer attributes (`set(key, value)`),
and opens the range `torch.profiler.record_function(name)` opens, so
that a profiler running around it shows the same range. torch's profiler
stamps host events in Unix-epoch nanoseconds, the clock of
`time.time_ns()`, so a kept span can be laid over the device trace's
kernels and idle gaps. The span reads the clock just before each of
the range's two stamps, with no Python allocation in between: a garbage
collection (whose callbacks may take milliseconds) starts only where
Python allocates, so it never falls between a reading and its stamp.
No span waits for the device: a span around asynchronous launches
times their launch, and one that must include the device's work has a
synchronising call inside it.

A request is one frame (one RenderSession) or one Adam step: its spans
share one id. A span takes the request it is given, else its parent's,
else a new one. The parent is the innermost span open on the same
thread; on a thread with none open (autograd's worker thread, which runs
a CUDA backward) it is the innermost span open on the thread that opened
the current request, so the backward's checkpoint recompute hangs under
`ct.inverse.backward` with the step's id.

The spans, and the quantity each is there to measure:
`ct.session.setup` (the session's set-up) with `ct.scene.compile`,
`ct.session.key` and `ct.session.lights`; `ct.scene.update` (attrs
`spheres`, `bytes`: `RenderSession.update_scene`'s edit of the tables on
their device); `ct.session.dispatch`;
`ct.film.fetch` (attr `bytes`; the one fetch of the image);
`ct.film.tonemap`; `ct.png.deflate` (attrs `bytes_in`, `bytes_out`);
`ct.frame` (render_scene's whole frame); `ct.inverse.step` with
`ct.inverse.forward`, `ct.inverse.backward`, `ct.inverse.adam` (the
Adam step's phases); `ct.integrator.bounce` (attr `depth`; the kernels
a bounce launches) and `ct.rng.draws` (the device time of the draws).
The command line's `--profile-dir` switches them on in its trace.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

_on = False
_kept: List["Span"] = []
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
# The span stack of the thread that opened the open request, read by
# threads that have no span open of their own.
_owner: Optional[list] = None


class _NoSpan:
    """The shared context `span` returns while tracing is off."""

    __slots__ = ()
    request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value: int) -> None:
        pass


_NOOP = _NoSpan()


@functools.lru_cache(maxsize=None)
def _range_ops():
    """The profiler's own enter and exit of a `record_function` range, as
    the C++ operators that stamp the range's start and end. Called
    directly, they allocate no Python object before the stamp, where
    `record_function.__enter__` and `__exit__` make several."""
    return (torch.ops.profiler._record_function_enter_new.default._op,
            torch.ops.profiler._record_function_exit._RecordFunction._op)


class Span:
    """One span; kept once it has closed."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns", "attrs",
                 "_range")

    def __init__(self, name: str, request: Optional[int]):
        self.name = name
        self.request = request
        self.attrs: Dict[str, int] = {}

    def __enter__(self):
        global _owner
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            parent = stack[-1]
        else:
            top = _owner[-1:] if _owner is not None else ()
            parent = top[0] if top else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if self.request is None:
            self.request = parent.request if parent is not None else next(_requests)
        if not stack and parent is None:
            _owner = stack
        self.thread = threading.get_ident()
        enter, _ = _range_ops()
        # The clock is read next to the profiler's own stamp, with no
        # Python allocation between them (an allocation may start a garbage
        # collection and its callbacks), and before it: the operator lets
        # go of the GIL, and taking it back may wait on another thread.
        self.start_ns = time.time_ns()
        self._range = enter(self.name, None)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _owner
        _, leave = _range_ops()
        self.end_ns = time.time_ns()
        leave(self._range)
        self._range = None
        stack = _local.stack
        stack.pop()
        if not stack and _owner is stack:
            _owner = None
        _kept.append(self)
        return False

    def set(self, key: str, value: int) -> None:
        """An integer attribute of the span (a byte count, a depth)."""
        self.attrs[key] = int(value)

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": dict(self.attrs)}


def span(name: str, request: Optional[int] = None):
    """A span around the block, kept while tracing is on; `request` names
    the request it belongs to (by default its parent's, or a new one)."""
    if not _on:
        return _NOOP
    return Span(name, request)


def enable() -> List[Span]:
    """Switch tracing on; the list the closed spans are kept in, from now."""
    global _on, _kept
    _kept = []
    _on = True
    return _kept


def disable() -> List[Span]:
    """Switch tracing off; the spans kept since `enable`."""
    global _on
    _on = False
    return _kept


@contextlib.contextmanager
def collect():
    """Tracing on within the block; yields the list the spans are kept in."""
    kept = enable()
    try:
        yield kept
    finally:
        disable()
