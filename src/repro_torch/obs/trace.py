"""Query tracing: host-side span trees around compiled stage calls.

A ``QueryTrace`` is a tree of ``Span``s covering one query's path through
the stack — plan-cache lookup, per-stage device dispatch, mask/merge/top-k,
micro-batcher scatter-back.  Spans are opened and closed strictly HOST-SIDE
(``timed_span`` wraps the *call* to a plan or a captured CUDA graph, never
runs inside a capture), so tracing can never perturb what the device runs.

A timing caveat the reader must know: CUDA launches are asynchronous, so a
span around a launch or a graph replay measures host dispatch time unless
something downstream blocks; the engine's ``sync`` span (around the
device->host copy of the final top-k) is where outstanding device work
completes.
Per-stage spans are therefore a *structure + dispatch-cost* record on
accelerators and close to wall time on CPU.  (DESIGN.md §9.)

The active trace is thread-local: ``with trace("query"):`` activates one,
any ``span()``/``timed_span()`` underneath nests into it, and a thread with
no active trace pays a single attribute check.  ``Tracer`` adds 1-in-N
deterministic sampling for serving loops.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .registry import DEFAULT_LATENCY_EDGES_US
from .registry import enabled as _metrics_enabled
from .registry import registry as _registry

_LOCAL = threading.local()


class Span:
    __slots__ = ("name", "attrs", "t_start", "t_end", "children")

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 t_start: float = 0.0) -> None:
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.children: List["Span"] = []

    @property
    def duration_us(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1e6

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_us": self.duration_us,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


class QueryTrace:
    """One query's span tree.  ``push``/``pop`` maintain a stack, so spans
    opened while another is active nest under it; ``render()`` pretty-prints
    the tree for sampled dumps."""

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 clock=time.perf_counter) -> None:
        self._clock = clock
        self.root = Span(name, attrs, t_start=clock())
        self._stack: List[Span] = [self.root]

    def push(self, name: str, **attrs: object) -> Span:
        sp = Span(name, attrs, t_start=self._clock())
        self._stack[-1].children.append(sp)
        self._stack.append(sp)
        return sp

    def pop(self, span: Span) -> None:
        span.t_end = self._clock()
        # Tolerate mis-nested pops (an exception unwound past a span): close
        # everything above `span` on the stack rather than corrupting it.
        while len(self._stack) > 1:
            top = self._stack.pop()
            if top.t_end is None:
                top.t_end = span.t_end
            if top is span:
                break

    def finish(self) -> "QueryTrace":
        now = self._clock()
        while self._stack:
            top = self._stack.pop()
            if top.t_end is None:
                top.t_end = now
        return self

    def to_dict(self) -> dict:
        return self.root.to_dict()

    def render(self, indent: str = "  ") -> str:
        lines: List[str] = []

        def walk(sp: Span, depth: int) -> None:
            dur = sp.duration_us
            dur_s = "..." if dur is None else f"{dur:.0f}us"
            attrs = "".join(f" {k}={v}" for k, v in sorted(sp.attrs.items()))
            lines.append(f"{indent * depth}{sp.name} {dur_s}{attrs}")
            for c in sp.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


def current_trace() -> Optional[QueryTrace]:
    return getattr(_LOCAL, "trace", None)


@contextmanager
def trace(name: str, **attrs: object):
    """Activate a QueryTrace on this thread; restores any outer trace."""
    prev = current_trace()
    tr = QueryTrace(name, attrs)
    _LOCAL.trace = tr
    try:
        yield tr
    finally:
        tr.finish()
        _LOCAL.trace = prev


class _NullCm:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCm()


class _TimedSpan:
    """Times one host-side block: appends a child span to the active trace
    (if any) and observes the duration into a registry histogram (if metrics
    are enabled and a histogram name was given)."""

    __slots__ = ("_name", "_hist", "_edges", "_labels", "_attrs",
                 "_tr", "_sp", "_t0")

    def __init__(self, name, hist, edges, labels, attrs) -> None:
        self._name = name
        self._hist = hist
        self._edges = edges
        self._labels = labels
        self._attrs = attrs
        self._tr = None
        self._sp = None
        self._t0 = 0.0

    def __enter__(self) -> Optional[Span]:
        self._tr = current_trace()
        if self._tr is not None:
            self._sp = self._tr.push(self._name, **(self._attrs or {}))
        self._t0 = time.perf_counter()
        return self._sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt_us = (time.perf_counter() - self._t0) * 1e6
        if self._sp is not None:
            if exc_type is not None:
                self._sp.attrs["error"] = exc_type.__name__
            self._tr.pop(self._sp)
        if self._hist is not None and _metrics_enabled():
            _registry().histogram(
                self._hist, self._edges,
                **(self._labels or {})).observe(dt_us)
        return False


def timed_span(name: str, *, histogram: Optional[str] = None,
               edges: Tuple[float, ...] = DEFAULT_LATENCY_EDGES_US,
               labels: Optional[dict] = None,
               attrs: Optional[dict] = None):
    """Context manager: time a host-side block into ``histogram`` (us) and,
    when a trace is active, record it as a nested span.  Free (a shared
    null object) when there is nothing to record."""
    if current_trace() is None and (histogram is None or not _metrics_enabled()):
        return _NULL_CM
    return _TimedSpan(name, histogram, edges, labels, attrs)


def span(name: str, **attrs: object):
    """Trace-only child span (no histogram)."""
    return timed_span(name, attrs=attrs)


class Tracer:
    """Deterministic 1-in-N sampler for serving loops.

    ``maybe(name)`` activates a full QueryTrace on the 1st, (N+1)th, ...
    call and a no-op otherwise; completed traces accumulate (bounded) until
    ``drain()``.  N == 0 disables sampling entirely.
    """

    def __init__(self, sample_every: int = 0, keep: int = 64) -> None:
        self.sample_every = int(sample_every)
        self.keep = int(keep)
        self.traces: List[QueryTrace] = []
        self._n = 0

    def maybe(self, name: str, **attrs: object):
        self._n += 1
        if self.sample_every <= 0 or (self._n - 1) % self.sample_every:
            return _NULL_CM
        return self._capture(name, attrs)

    @contextmanager
    def _capture(self, name: str, attrs: dict):
        with trace(name, **attrs) as tr:
            yield tr
        if len(self.traces) < self.keep:
            self.traces.append(tr)

    def drain(self) -> List[QueryTrace]:
        out, self.traces = self.traces, []
        return out
