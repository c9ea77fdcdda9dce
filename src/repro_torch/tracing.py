"""The program's own spans and counters for the S-SGD step.

Tracing is on only inside ``with record(device) as rec:`` and off
everywhere else: off, a boundary of the step costs one Python check, no
autograd node is inserted and no event is made.

On, each span records its name, its parent, the unit index where there is
one, and its start and end on the device's clock: a CUDA event with
``enable_timing=True`` recorded on the current stream (on the CPU, the
host's ``time.perf_counter_ns`` stands in).  A step is a span opened with
nothing open (``step`` in the training steps); its start is the step's
origin, where the device is idle when the caller read the previous step's
loss, and every time of the step is given in milliseconds from it.

Events are resolved only once their step is known to be finished: in a
later step, when a span directly under that step's top span closes and the
device has passed every event of the earlier step (``Event.query``, which
does not wait), or else in :meth:`Recorder.summary` after the traced
steps.  So the work of resolving falls where the host runs ahead of the
device, not at a step's start, where the device waits for the host.  Inside a step the
tracer never calls ``torch.cuda.synchronize``, ``.item()`` or ``.cpu()``.
A resolved step is folded into the recorder's totals by span name and
handed to the ``on_step`` callback of :func:`record`, if any; the recorder
keeps neither its events nor its spans.

**Where the spans sit** (the names are those of the program's layers):

- ``step``: :func:`repro_torch.comm.ddp.make_ddp_train_step`'s step and
  :func:`repro_torch.launch.steps.make_train_step`'s train step; its
  children ``fwd`` and ``bwd`` (:func:`repro_torch.launch.steps.
  loss_and_grads`: the loss, then ``torch.autograd.grad``) and ``update``
  (:mod:`repro_torch.optim.sgd`).  The rest of the step (the gradient
  synchronization, the global norm, the metric means) is ``step`` less its
  children.
- Model boundaries (:func:`boundary`, in :func:`repro_torch.models.
  transformer._final_hidden`): one on the hidden states before each unit
  (before the unit's parameter slice, outside ``torch.utils.checkpoint``)
  and one after the last unit.  They split the innermost open span into
  segments: ``fwd`` into ``fwd.embed``, ``fwd.unit`` (one a unit) and
  ``fwd.head`` (any remainder blocks, the final norm, the head and the
  loss).  Each boundary is an identity ``autograd.Function`` whose backward
  marks the same place on the way back, so ``bwd`` splits into
  ``bwd.head``, ``bwd.unit`` (last unit first; a unit's segment runs from
  the boundary above it to its own, so it holds the unit's recompute under
  remat and its slice's gradient added into the stacked leaf) and
  ``bwd.embed`` (from unit 0's boundary to the end of the backward).
- ``fwd.loss`` / ``bwd.loss``: the cross-entropy's forward and backward
  (:mod:`repro_torch.models.loss`), inside ``fwd.head`` / ``bwd.head``.
- Counter ``loader.wait``: seconds the consumer of
  :class:`repro_torch.data.pipeline.PrefetchLoader` waited for a batch.
- Counter ``loss.split_chunks``: vocab chunks of the chunked
  cross-entropy's backward whose two products ran through the exact
  three-term split of ``dlogits``, on the tensor cores on CUDA (x and head
  bfloat16; :mod:`repro_torch.models.loss`); 0 for f32 or fp16 inputs.

No span is a ``torch.profiler`` range: a profiler mirrors those onto the
device's track, where they would read as device work.

:mod:`repro_torch.traces.recorded` turns recorded steps into the paper's
layer-wise trace.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import Callable

import torch

#: the layers before a span's first model boundary
FIRST = "embed"

_CURRENT: contextvars.ContextVar["Recorder | None"] = contextvars.ContextVar(
    "repro_torch_tracing", default=None)
_OFF = contextlib.nullcontext()


def current() -> "Recorder | None":
    """The recorder of the innermost :func:`record` block; None when off."""
    return _CURRENT.get()


@contextlib.contextmanager
def record(device="cuda", on_step: Callable[[int, list[dict]], None] | None = None):
    """Turn tracing on for the block; yields the :class:`Recorder`, whose
    :meth:`~Recorder.summary` resolves what is still open.  ``on_step(index,
    spans)`` is called with each resolved step (:meth:`Recorder._numbers`)."""
    rec = Recorder(device, on_step)
    token = _CURRENT.set(rec)
    try:
        yield rec
    finally:
        _CURRENT.reset(token)


def span(name: str):
    """A context manager timing the block as span ``name`` (a no-op when
    off)."""
    return span_on(_CURRENT.get(), name)


def spanned(name: str):
    """Decorate a function so that each call is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def span_on(rec: "Recorder | None", name: str):
    """:func:`span` on ``rec``, for code that runs where the context of the
    :func:`record` block is not seen (an ``autograd.Function``'s backward
    on the autograd engine's device thread keeps the recorder of its
    forward)."""
    return _OFF if rec is None else _Open(rec, name)


def timed(name: str):
    """A context manager adding the block's host seconds to counter
    ``name`` (a no-op when off)."""
    rec = _CURRENT.get()
    return _OFF if rec is None else _Timed(rec, name)


def boundary(x: torch.Tensor, kind: str, unit: int | None = None) -> torch.Tensor:
    """``x``, marking that layer ``kind`` (``unit``) starts here: a mark in
    the forward and, through an identity ``autograd.Function``, one where
    ``x``'s gradient passes on the way back.  Off, ``x`` itself."""
    rec = _CURRENT.get()
    if rec is None or not rec._stack:
        return x
    return _Boundary.apply(x, rec, kind, unit)


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rec, kind, unit):
        ctx.rec, ctx.kind, ctx.unit = rec, kind, unit
        rec._boundary(kind, unit, backward=False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.rec._boundary(ctx.kind, ctx.unit, backward=True)
        return grad, None, None, None


class _Span:
    __slots__ = ("name", "parent", "segment", "start", "end", "marks")

    def __init__(self, name, parent, start):
        self.name, self.parent, self.start = name, parent, start
        # the parent's segment this span opened in (its model boundaries so far)
        self.segment = len(parent.marks) if parent is not None else 0
        self.end = None
        self.marks: list[tuple] = []            # (kind, unit, mark, backward)


class _Step:
    __slots__ = ("index", "origin", "spans")

    def __init__(self, index, origin):
        self.index, self.origin, self.spans = index, origin, []


class _Open:
    __slots__ = ("rec", "name", "span")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.span = self.rec._open(self.name)
        return self.span

    def __exit__(self, *exc):
        self.rec._close(self.span)
        return False


class _Timed:
    __slots__ = ("rec", "name", "t0")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.rec.count(self.name, (time.perf_counter_ns() - self.t0) * 1e-9)
        return False


class Recorder:
    """Spans and counters of the steps run inside one :func:`record` block
    (module docstring).  ``resolved``: the steps resolved so far;
    ``totals``: by span name, its ``count`` and total ``device_ms`` over
    them; ``counters``: by counter name, its total."""

    def __init__(self, device="cuda", on_step=None):
        self.device = torch.device(device)
        self.on_step = on_step
        self._events = self.device.type == "cuda"
        self._stack: list[_Span] = []
        self._step: _Step | None = None
        self._pending: list[_Step] = []
        self._begun = 0
        self.resolved = 0
        self.totals: dict[str, dict] = {}
        self.counters: dict[str, float] = {}

    # ---------------------------------------------------------------- marks
    def _mark(self):
        """A CUDA event recorded on the current stream; on the CPU, the host
        clock's nanoseconds."""
        if not self._events:
            return time.perf_counter_ns()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _open(self, name: str) -> _Span:
        mark = self._mark()
        if not self._stack:
            self._step = _Step(self._begun, mark)
            self._begun += 1
            self._pending.append(self._step)
        parent = self._stack[-1] if self._stack else None
        s = _Span(name, parent, mark)
        self._step.spans.append(s)
        self._stack.append(s)
        return s

    def _close(self, s: _Span) -> None:
        s.end = self._mark()
        if self._stack[-1] is not s:
            raise RuntimeError(f"span {s.name!r} closed while "
                               f"{self._stack[-1].name!r} is open")
        self._stack.pop()
        if len(self._stack) == 1 and self._pending[0] is not self._step:
            self._resolve(wait=False)

    def _boundary(self, kind: str, unit: int | None, backward: bool) -> None:
        if self._stack:
            self._stack[-1].marks.append((kind, unit, self._mark(), backward))

    def count(self, name: str, value: float) -> None:
        """Add ``value`` to counter ``name``."""
        self.counters[name] = self.counters.get(name, 0.0) + value

    # ----------------------------------------------------------- resolution
    def _resolve(self, wait: bool) -> None:
        """Resolve the finished steps, oldest first: those the device has
        passed, or (``wait``) every closed one."""
        while self._pending and (self._pending[0] is not self._step or not self._stack):
            st = self._pending[0]
            if self._events:
                events = [m for s in st.spans for m in (s.start, s.end, *(b[2] for b in s.marks))]
                if wait:
                    for e in events:
                        e.synchronize()
                elif not all(e.query() for e in events):
                    return
            spans = self._numbers(st)
            self._pending.pop(0)
            if st is self._step:
                self._step = None
            self.resolved += 1
            for s in spans:
                t = self.totals.setdefault(s["name"], {"count": 0, "device_ms": 0.0})
                t["count"] += 1
                t["device_ms"] += s["end_ms"] - s["start_ms"]
            if self.on_step is not None:
                self.on_step(st.index, spans)

    def _numbers(self, st: _Step) -> list[dict]:
        """The step's spans, each a dict of ``id``, ``name``, ``parent`` (an
        ``id``, None at the top), ``unit`` and ``start_ms`` / ``end_ms``
        from the step's origin; a span's children follow it."""
        o = st.origin
        at = ((lambda m: o.elapsed_time(m)) if self._events else
              (lambda m: (m - o) * 1e-6))
        out: list[dict] = []
        ids: dict[int, int] = {}                 # id(span) -> its entry's id
        segments: dict[int, list[int]] = {}      # id(span) -> its segments' ids

        def add(name, parent, unit, start, end):
            out.append({"id": len(out), "name": name, "parent": parent, "unit": unit,
                        "start_ms": at(start), "end_ms": at(end)})
            return len(out) - 1

        for s in st.spans:
            parent = None
            if s.parent is not None:
                segs = segments.get(id(s.parent))
                parent = segs[s.segment] if segs else ids[id(s.parent)]
            ids[id(s)] = add(s.name, parent, None, s.start, s.end)
            if s.marks:
                segments[id(s)] = self._segments(s, ids[id(s)], add)
        return out

    @staticmethod
    def _segments(s: _Span, sid: int, add) -> list[int]:
        """The segments of ``s`` between its start, its model boundaries and
        its end.  Forward, a segment is the layer that starts at its first
        edge; backward (the boundaries come last layer first), the layer
        that starts at its last edge; :data:`FIRST` where that is the span's
        own edge."""
        edges = [(FIRST, None, s.start)] + s.marks + [(FIRST, None, s.end)]
        backward = s.marks[0][3]
        out = []
        for a, b in zip(edges, edges[1:]):
            kind, unit = (b[0], b[1]) if backward else (a[0], a[1])
            out.append(add(f"{s.name}.{kind}", sid, unit, a[2], b[2]))
        return out

    # -------------------------------------------------------------- reading
    def summary(self) -> dict:
        """Resolve every closed step (waiting for the device) and give
        ``device``, the device type (``cpu``: device times are the host's);
        ``steps``, the steps resolved; ``spans``, :attr:`totals`; and
        ``counters``."""
        self._resolve(wait=True)
        return {"device": self.device.type, "steps": self.resolved,
                "spans": {k: dict(v) for k, v in self.totals.items()},
                "counters": dict(self.counters)}
