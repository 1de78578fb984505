"""Query tracing: span trees of the host's work and of the device's.

A ``QueryTrace`` is a tree of ``Span``s covering one query's path through
the stack: the batcher's requests (each ``batcher.submit`` call and its
``batcher.queue`` wait, one request id on both), ``batcher.flush``, the
plan-cache lookup, ``execute`` with its ``stream_wait``, ``sync``, the
batcher's scatter-back, and the device's stages (``device.<stage>``,
``device.h2d``, ``device.d2h``).  Host spans are opened and closed
HOST-SIDE (``timed_span`` wraps the *call* to a plan or a captured CUDA
graph, never runs inside a capture), so tracing can never perturb what the
device runs.

A span has a kind: ``HOST`` (the host works), ``WAIT`` (the host waits: a
request in the queue, the engine on the stream) or ``DEVICE`` (the device
works).  On the card launches are asynchronous: a host span around a launch
or a replay measures dispatch, and the device's work completes inside
``execute``'s ``stream_wait`` spans (``_Graph.replay`` waits for the stream
there; ``sync`` then copies from pinned memory).  Device spans come from
CUDA timing events: each stage of a captured graph records an event at its
start and end (graph nodes, read after the wait that ends the replay), and
the copies in and out are timed the same way.  The first device use under a
trace takes one anchor, an event recorded on the idle stream with the host
clock read around it, and every event converts to the host clock by its
``elapsed_time`` from the anchor.  On the CPU the stages run eagerly and are
timed by the host clock (``clock``), into the same spans.

A trace with device spans puts, when it finishes, each stretch of its
extent (its first span's start to its end) in which the device ran nothing
down to the innermost host span open then, wait spans left out, or to
``caller`` where no span of the program is open (``idle_stretches``); the
totals by cause are ``QueryTrace.idle`` and are observed, one value a cause
a trace, into the registry histogram ``trace.device_idle_us{cause=...}``.
(DESIGN.md §9.)

The active trace is thread-local: ``with trace("query"):`` activates one,
any ``span()``/``timed_span()`` underneath nests into it, and a thread with
no active trace pays a single attribute check.  ``Tracer`` adds 1-in-N
deterministic sampling for serving loops.
"""

from __future__ import annotations

import operator
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .registry import DEFAULT_LATENCY_EDGES_US
from .registry import enabled as _metrics_enabled
from .registry import registry as _registry

_LOCAL = threading.local()


#: The host clock of every span (seconds); the engine reads it from here.
clock = time.perf_counter

#: Span kinds: the host works, the host waits, the device works.
HOST, WAIT, DEVICE = "host", "wait", "device"
#: The cause of idle device time while no span of the program is open.
CALLER = "caller"
#: Histogram of a trace's device-idle time (us) by cause.
IDLE_HISTOGRAM = "trace.device_idle_us"


class Span:
    __slots__ = ("name", "attrs", "t_start", "t_end", "children", "kind")

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 t_start: float = 0.0, kind: str = HOST) -> None:
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.children: List["Span"] = []
        self.kind = kind

    @property
    def duration_us(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1e6

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "duration_us": self.duration_us,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


_SPAN = object.__new__


class QueryTrace:
    """One query's span tree.  ``push``/``pop`` maintain a stack, so spans
    opened while another is active nest under it; ``add`` and
    ``add_events`` attach finished spans; ``render()`` pretty-prints the
    tree and the device's idle time by cause for sampled dumps."""

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 clock=clock) -> None:
        self._clock = clock
        self.root = Span(name, attrs, t_start=clock())
        self._stack: List[Span] = [self.root]
        self.anchor: Optional[Tuple[object, float]] = None   # (event, host s)
        self.idle: Optional[Dict[str, float]] = None          # s by cause
        self._device = False

    @property
    def open_span(self) -> Span:
        """The innermost open span."""
        return self._stack[-1]

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

    def add(self, name: str, t_start: float, t_end: float, *,
            parent: Optional[Span] = None, kind: str = HOST,
            **attrs: object) -> Span:
        """A finished span from ``t_start`` to ``t_end`` (host clock), a
        child of ``parent`` (default: the innermost open span)."""
        sp = _SPAN(Span)        # the fields at once: a request's spans are many
        sp.name, sp.attrs, sp.t_start, sp.t_end, sp.children, sp.kind = \
            name, attrs, t_start, t_end, [], kind
        (self._stack[-1] if parent is None else parent).children.append(sp)
        if kind == DEVICE:
            self._device = True
        return sp

    def set_anchor(self, event: object, t_host: float, error_s: float) -> None:
        """The device clock's origin for ``add_events``: a CUDA timing event
        that ran at host time ``t_host``, within ``error_s``."""
        self.anchor = (event, t_host)
        self.root.attrs["anchor_err_us"] = round(error_s * 1e6, 2)

    def add_events(self, name: str, start: object, end: object) -> Span:
        """A device span between two completed CUDA timing events, on the
        host clock through the anchor, under the innermost open span."""
        origin, t0 = self.anchor
        return self.add(name, t0 + origin.elapsed_time(start) / 1e3,
                        t0 + origin.elapsed_time(end) / 1e3, kind=DEVICE)

    def finish(self) -> "QueryTrace":
        now = self._clock()
        while self._stack:
            top = self._stack.pop()
            if top.t_end is None:
                top.t_end = now
        if self._device and self.idle is None:
            self.idle = {}
            for cause, a, b in idle_stretches(self.root):
                self.idle[cause] = self.idle.get(cause, 0.0) + (b - a)
            if _metrics_enabled():
                for cause, s in self.idle.items():
                    _registry().histogram(IDLE_HISTOGRAM, cause=cause).observe(s * 1e6)
        return self

    def to_dict(self) -> dict:
        return self.root.to_dict()

    def render(self, indent: str = "  ") -> str:
        lines: List[str] = []

        def walk(sp: Span, depth: int) -> None:
            dur = sp.duration_us
            dur_s = "..." if dur is None else f"{dur:.0f}us"
            kind = "" if sp.kind == HOST else f" [{sp.kind}]"
            attrs = "".join(f" {k}={v}" for k, v in sorted(sp.attrs.items()))
            lines.append(f"{indent * depth}{sp.name} {dur_s}{kind}{attrs}")
            for c in sorted(sp.children, key=lambda c: c.t_start):
                walk(c, depth + 1)

        walk(self.root, 0)
        for cause, s in sorted((self.idle or {}).items(), key=lambda kv: -kv[1]):
            lines.append(f"device idle {s * 1e6:.0f}us in {cause}")
        return "\n".join(lines)


def idle_stretches(root: Span) -> List[Tuple[str, float, float]]:
    """(cause, start, end) of every stretch of ``root``'s extent (the
    earliest start in its tree to its end) in which no ``DEVICE`` span of
    the tree runs, split at host span boundaries: each piece is put down to
    the innermost ``HOST`` span open then (``WAIT`` spans, and what nests in
    them, are left out) or, where none but the root is, to ``CALLER``.  The
    pieces partition the idle time: where two sibling spans overlap, the
    one that starts first takes the overlap."""
    busy, t = [], root.t_start
    stack = [root]
    while stack:
        for c in stack.pop().children:
            if c.t_start < t:
                t = c.t_start
            if c.kind == DEVICE:
                busy.append((c.t_start, c.t_end))
            elif c.children:
                stack.append(c)
    end = root.t_end
    idle = []
    for a, b in sorted(busy):
        if a > t:
            idle.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        idle.append((t, end))
    out: List[Tuple[str, float, float]] = []
    _claim(root, [p for p in idle if p[1] > p[0]], CALLER, out)
    return out


_START = operator.attrgetter("t_start")


def _claim(span: Span, pieces: list, cause: str, out: list) -> None:
    """Hand ``pieces`` (sorted, disjoint) to ``span``'s host children in the
    order they start, each the part inside its extent that no earlier child
    took, and the rest to ``cause``: one sweep over children and pieces."""
    rest = pieces[::-1]        # a stack: the earliest piece last
    for c in sorted([c for c in span.children if c.kind == HOST], key=_START):
        while rest and rest[-1][1] <= c.t_start:
            out.append((cause,) + rest.pop())
        if not rest:
            break
        inside = []
        while rest and rest[-1][0] < c.t_end:
            a, b = rest.pop()
            if a < c.t_start:
                out.append((cause, a, c.t_start))
                a = c.t_start
            if b > c.t_end:
                inside.append((a, c.t_end))
                rest.append((c.t_end, b))
                break
            inside.append((a, b))
        if inside and c.children:
            _claim(c, inside, c.name, out)
        elif inside:
            out.extend((c.name, a, b) for a, b in inside)
    out.extend((cause, a, b) for a, b in reversed(rest))


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

    __slots__ = ("_name", "_hist", "_edges", "_labels", "_attrs", "_kind",
                 "_tr", "_sp", "_t0")

    def __init__(self, name, hist, edges, labels, attrs, kind=HOST) -> None:
        self._name = name
        self._kind = kind
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
            self._sp.kind = self._kind
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


def wait_span(name: str, **attrs: object):
    """Trace-only child span of kind ``WAIT``: the host waits in it."""
    if current_trace() is None:
        return _NULL_CM
    return _TimedSpan(name, None, DEFAULT_LATENCY_EDGES_US, None, attrs, WAIT)


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
