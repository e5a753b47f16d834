"""The program's spans: named intervals at its layer boundaries, kept in
memory while a torch profiler runs, on the clock that the profiler stamps
its own events with.

    with spans.span("lego.step", step_idx=i):
        ...
    out = spans.region("lego.user_encode", encode, clicks)

A span is recorded only while a profiler runs (`torch.profiler.profile`,
the condition `ops/build.launch_range` uses); otherwise `span` returns one
shared null context after a single flag check, and `region` calls its
function as it is, so that the autograd graph is what it would be without
it. A record holds the span's name, `start_ns` and `end_ns` from
`time.time_ns()` (kineto's host events are stamped on the same
Unix-epoch nanosecond clock, so the spans join a profiler trace by time),
the native id of the thread that opened it, the index of the span that
was open on that thread when it opened (`parent`, None at the top) and
its keyword attributes (`lego.step` carries its `step_idx`).

The spans are not profiler ranges: a `record_function` range also shows
on the device side of a trace, where a reader of the trace would count it
as device work. `ops/build.launch_range` stays the one kind of profiler
range, around the kernel wrappers' launches.

`region(name, fn, *tensors)` times a forward region and, while recording
with gradients on, its backward: the autograd engine runs a region's
backward later, often on its own thread, after the forward's span has
closed. Two identity autograd Functions mark the region's output, whose
backward opens `<name>.backward` on the thread that runs it, and its
differentiable inputs, whose backwards close it once the gradient has
reached all of them (or the backward pass ends, for a region whose only
differentiable inputs are parameters). Both return their input and its
gradient as they are and launch no kernel.

`take()` returns the records and clears them; `dump(path)` writes what
`take()` returns as JSON.
"""
import contextlib
import json
import threading
import time

import torch

_NULL = contextlib.nullcontext()
_records = []
_local = threading.local()


class _Record:
    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "attrs")

    def __init__(self, name, attrs, parent):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.thread = threading.get_native_id()
        self.end_ns = None
        self.start_ns = time.time_ns()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(name: str, attrs: dict):
    """A new record, open on this thread: (record, its thread's stack)."""
    stack = _stack()
    rec = _Record(name, attrs, stack[-1] if stack else None)
    _records.append(rec)
    stack.append(rec)
    return rec, stack


def _close(rec, stack):
    rec.end_ns = time.time_ns()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is rec:
            del stack[i]
            break


class _Span:
    __slots__ = ("name", "attrs", "_open")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._open = _open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        _close(*self._open)
        return False


def span(name: str, **attrs):
    """A context manager: the span `name` while a profiler runs, a shared
    null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, attrs)


# ------------------------------------------------------------------------ #
# a region's backward                                                      #
# ------------------------------------------------------------------------ #
class _Backward:
    """The backward span of one region: opened by the output's marker,
    closed when the gradient has left through every marked input."""

    def __init__(self, name: str, inputs: int):
        self.name, self.pending, self.open = name, inputs, None

    def start(self):
        if self.open is None and torch.autograd._profiler_enabled():
            self.open = _open(self.name, {})
            torch.autograd.Variable._execution_engine.queue_callback(
                self.end)

    def input_done(self):
        self.pending -= 1
        if self.pending <= 0:
            self.end()

    def end(self):
        if self.open:
            _close(*self.open)
            self.open = False


class _OutputMark(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bw):
        ctx.bw = bw
        return x

    @staticmethod
    def backward(ctx, g):
        ctx.bw.start()
        return g, None


class _InputMark(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bw):
        ctx.bw = bw
        return x

    @staticmethod
    def backward(ctx, g):
        ctx.bw.input_done()
        return g, None


def region(name: str, fn, *tensors):
    """fn(*tensors) inside the span `name`; while a profiler runs with
    gradients on, the backward of what fn computed from the tensors (and
    from parameters) inside the span `name + ".backward"`. fn returns one
    tensor."""
    if not torch.autograd._profiler_enabled():
        return fn(*tensors)
    marks = torch.is_grad_enabled()
    if marks:
        bw = _Backward(name + ".backward",
                       sum(t.requires_grad for t in tensors))
        tensors = tuple(_InputMark.apply(t, bw) if t.requires_grad else t
                        for t in tensors)
    with _Span(name, {}):
        out = fn(*tensors)
    if marks and out.requires_grad:
        out = _OutputMark.apply(out, bw)
    return out


# ------------------------------------------------------------------------ #
def take() -> list:
    """The records so far, as dicts (`parent` an index into the list, None
    at the top or where the parent was taken before), and clears them. A
    span still open has `end_ns` None."""
    n = len(_records)
    recs = _records[:n]
    del _records[:n]
    index = {id(r): i for i, r in enumerate(recs)}
    return [{"name": r.name, "start_ns": r.start_ns, "end_ns": r.end_ns,
             "thread": r.thread,
             "parent": None if r.parent is None else index.get(id(r.parent)),
             "attrs": dict(r.attrs)} for r in recs]


def dump(path: str) -> list:
    """Writes take()'s records to `path` as a JSON list; returns them."""
    recs = take()
    with open(path, "w") as f:
        json.dump(recs, f)
    return recs
