"""Nestable request spans with per-request trace ids.

A copy of ``repro/obs/trace.py`` (the port imports nothing of the
reference).  A *span* is a named interval (`t0`..`t1` on the
`perf_counter` clock) tied to one trace id; spans opened while another
span of the same trace is open become its children, so a JSONL dump
reconstructs the full causal tree of a request: identify -> route ->
retrieve/federate -> queue_wait -> prefill -> decode_segment* -> decode
-> detokenize.

Three shapes cover every call site in the serving hierarchy:

* ``span(name, trace=...)`` — ordinary per-request context manager.
* ``span(name, traces=[...])`` — one *batched* stage (identify, route,
  a decode segment) that covers many requests at once: one wall-clock
  interval, one event emitted per participating trace.
* ``emit(name, trace, t0, t1)`` — retroactive span for intervals whose
  endpoints were observed without a context manager (queue wait,
  admission-to-completion decode latency).

Disabled mode is the default and is *free*: ``span()`` returns a
shared null context manager without reading the clock (the port's
tests monkeypatch this module's ``perf_counter`` to prove it), and
``emit``/``event`` return immediately.

Spans time the host: PyTorch launches CUDA work asynchronously, so a
span that encloses launches closes once they are enqueued, not once the
device finishes them.  Where the serving path already waits for the
device (a refill's first token, each decode step's token read-back),
the span covers that wait too.  Nothing here synchronises the device.
"""
from __future__ import annotations

import itertools
from time import perf_counter
from typing import Dict, List, Optional, Sequence


class _NullSpan:
    """Shared disabled-mode span: no clock reads, no allocation."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("trace", "sid", "parent", "name", "t0", "t1", "attrs")

    def __init__(self, trace, sid, parent, name, t0, attrs):
        self.trace = trace
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs

    def to_event(self):
        ev = {"kind": "span", "trace": self.trace, "id": self.sid,
              "parent": self.parent, "name": self.name,
              "t0": self.t0, "t1": self.t1}
        if self.attrs:
            ev["attrs"] = self.attrs
        return ev


class _SpanCtx:
    """Live context manager over one or more per-trace spans."""
    __slots__ = ("_tracer", "_spans")

    def __init__(self, tracer, spans):
        self._tracer = tracer
        self._spans = spans

    def __enter__(self):
        return self

    def set(self, **attrs):
        for s in self._spans:
            s.attrs = dict(s.attrs or {}, **attrs)
        return self

    def __exit__(self, *exc):
        t1 = perf_counter()
        for s in self._spans:
            s.t1 = t1
            self._tracer._close(s)
        return False


class Tracer:
    """Global span emitter; one open-span stack per trace id."""

    def __init__(self):
        self.enabled = False
        self.recorder = None
        self._stacks: Dict[str, List[int]] = {}
        self._ids = itertools.count(1)
        self._n_traces = itertools.count(1)

    # ------------------------------------------------------------- api
    def span(self, name: str, trace: Optional[str] = None,
             traces: Optional[Sequence[Optional[str]]] = None, **attrs):
        """Open a span (context manager). ``traces`` makes it batched:
        one interval, one event per trace id."""
        if not self.enabled:
            return NULL_SPAN
        t0 = perf_counter()
        tids = list(traces) if traces is not None else [trace]
        if not tids:
            tids = [None]
        spans = []
        for tid in tids:
            tid = str(tid) if tid is not None else "-"
            stack = self._stacks.setdefault(tid, [])
            parent = stack[-1] if stack else None
            s = _Span(tid, next(self._ids), parent, name, t0,
                      dict(attrs) if attrs else None)
            stack.append(s.sid)
            spans.append(s)
        return _SpanCtx(self, spans)

    def emit(self, name: str, trace: Optional[str], t0: float, t1: float,
             **attrs):
        """Record an already-finished interval as a child of whatever
        span is currently open for ``trace``."""
        if not self.enabled:
            return
        tid = str(trace) if trace is not None else "-"
        stack = self._stacks.get(tid)
        parent = stack[-1] if stack else None
        s = _Span(tid, next(self._ids), parent, name, t0,
                  dict(attrs) if attrs else None)
        s.t1 = t1
        self.recorder.record(s.to_event())

    def event(self, name: str, trace: Optional[str] = None, **attrs):
        """Point-in-time marker (e.g. a cache hit/miss)."""
        if not self.enabled:
            return
        t = perf_counter()
        tid = str(trace) if trace is not None else "-"
        stack = self._stacks.get(tid)
        ev = {"kind": "event", "trace": tid, "id": next(self._ids),
              "parent": stack[-1] if stack else None, "name": name, "t": t}
        if attrs:
            ev["attrs"] = attrs
        self.recorder.record(ev)

    def now(self) -> float:
        """Clock read for retroactive spans; 0.0 while disabled so
        callers can stamp unconditionally without paying for the read."""
        return perf_counter() if self.enabled else 0.0

    def new_trace(self, prefix: str = "r") -> str:
        return f"{prefix}{next(self._n_traces)}"

    def reset(self):
        self._stacks.clear()

    # -------------------------------------------------------- internal
    def _close(self, span: _Span):
        stack = self._stacks.get(span.trace)
        if stack and span.sid in stack:
            # tolerate out-of-order exits from interleaved batched spans
            stack.remove(span.sid)
        if self.recorder is not None:
            self.recorder.record(span.to_event())


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def query_trace(qid) -> str:
    """Canonical trace id for a cluster Query: ``q<qid>``."""
    return f"q{qid}"
