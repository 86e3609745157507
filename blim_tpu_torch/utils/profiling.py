"""Profiling hooks (port of blim_tpu/utils/profiling.py) and the program's
own tracer.

`trace` writes a `torch.profiler` trace of a scope (CPU activity, and CUDA
activity on a GPU) as a Chrome trace file, with the tracer on inside it.

The tracer: `span(name)` times a scope on the host clock (`time.time_ns`,
the clock torch.profiler stamps its events with) into the active `Tracer`
as a `Span` (name, start_ns, end_ns, parent, call): `parent` is the index
of the enclosing span in the tracer's list (-1 for none), `call` the id of
the span opened with `call=True` around it (one `evaluation` call; -1
outside any). A tracer is active inside `tracing()`; with none active a
span costs one module-global read and a shared null context: no allocation,
no clock read. Under a running torch.profiler an active span also opens a
`record_function` range of its name, so a profiler trace names the same
scopes. A span never synchronizes the device: it times the waits the
program makes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler

TRACE_FILE = "trace.json"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int     # index of the enclosing span in the same list, -1 for none
    call: int       # id of the enclosing call=True span, -1 outside any


class Tracer:
    """The spans recorded while this tracer was active, in the order they
    opened."""

    def __init__(self):
        self._spans: List[Optional[Span]] = []
        self._open: List["_Scope"] = []
        self._calls = 0
        self.last_closed: Optional[Span] = None

    def drain(self) -> List[Span]:
        """The recorded spans, then none; only with no span open."""
        if self._open:
            raise RuntimeError(f"{len(self._open)} span(s) still open")
        out, self._spans = self._spans, []
        return out


_active: Optional[Tracer] = None
_NULL = contextlib.nullcontext()


class _Scope:
    __slots__ = ("tracer", "name", "new_call", "index", "parent", "call", "start_ns", "_range")

    def __init__(self, tracer: Tracer, name: str, new_call: bool):
        self.tracer, self.name, self.new_call = tracer, name, new_call

    def __enter__(self) -> "_Scope":
        tr = self.tracer
        outer = tr._open[-1] if tr._open else None
        self.parent = outer.index if outer is not None else -1
        if self.new_call:
            self.call = tr._calls
            tr._calls += 1
        else:
            self.call = outer.call if outer is not None else -1
        self.index = len(tr._spans)
        tr._spans.append(None)
        tr._open.append(self)
        self._range = None
        if _torch_profiler._is_profiler_enabled:
            self._range = _torch_profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        tr = self.tracer
        rec = Span(self.name, self.start_ns, end, self.parent, self.call)
        tr._spans[self.index] = rec
        tr._open.pop()
        tr.last_closed = rec


def span(name: str, call: bool = False):
    """A context manager timing its body as `name` in the active tracer
    (a new call id with `call=True`); yields the open scope, whose
    `start_ns` is its start, or None with no tracer active."""
    tracer = _active
    if tracer is None:
        return _NULL
    return _Scope(tracer, name, call)


def closed_end_ns(name: str) -> Optional[int]:
    """The end of the span closed last in the active tracer, if it is
    `name`'s; else None (also with no tracer active). A mark taken right
    after a span closes reads the span's own boundary."""
    tracer = _active
    if tracer is None or tracer.last_closed is None or tracer.last_closed.name != name:
        return None
    return tracer.last_closed.end_ns


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Make `tracer` (a new one if None) the active one inside the scope,
    and the previous one active again after it; yields it."""
    global _active
    tracer = Tracer() if tracer is None else tracer
    previous, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = previous


def self_times(spans: List[Span], call: Optional[int] = None) -> Dict[str, int]:
    """Nanoseconds by name of each span's duration less the part its child
    spans cover (children nest inside their parent, one thread), over the
    spans of `call` (all with None)."""
    covered = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            covered[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, int] = {}
    for s, c in zip(spans, covered):
        if call is None or s.call == call:
            out[s.name] = out.get(s.name, 0) + (s.end_ns - s.start_ns - c)
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = TRACE_FILE):
    """torch.profiler over the scope, its Chrome trace written to
    log_dir/name when the scope ends (also on an error, as the JAX
    package's stop_trace), the tracer on inside so that the trace names
    the program's spans; a no-op for None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        with tracing():
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, name))
