"""Process-wide metrics: counters, gauges, fixed-bucket histograms.

The observability contract (DESIGN.md §9) in one sentence: everything is
measured HOST-SIDE, around compiled calls, never inside a traced function —
so a metrics-enabled search is byte-identical to a disabled one, and the
snapshot *structure* (metric names, label sets, histogram bucket edges) is
deterministic even though the observed latencies are not.

Histograms use fixed, committed bucket edges (a 1-2.5-5 decade ladder in
microseconds) rather than adaptive ones: two runs of the same workload emit
snapshots with identical shape, so trajectory tooling and dashboards can
diff them field-by-field.

Values are plain Python ints/floats mutated under the GIL; metric *creation*
is locked, increments are not — single-writer serving loops (the repo's
shape) observe exact counts, and concurrent writers degrade to approximate
counts, never corruption.  ``enable(False)`` turns every helper in
``repro_torch.obs`` into a no-op for overhead-sensitive runs; the bit-identity
tests flip it both ways and compare result bytes.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# Latency bucket edges in MICROSECONDS: a 1-2.5-5 ladder from 1us to 10s.
# Pinned by tests/test_obs.py — changing them is a snapshot-schema change.
DEFAULT_LATENCY_EDGES_US: Tuple[float, ...] = (
    1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1_000, 2_500, 5_000, 10_000, 25_000, 50_000,
    100_000, 250_000, 500_000,
    1_000_000, 2_500_000, 5_000_000, 10_000_000,
)

# Small-count edges (batch coalescing factors, queue depths): powers of two.
DEFAULT_COUNT_EDGES: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
)

Labels = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[dict]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def render_key(name: str, labels: Labels) -> str:
    """``name{k="v",...}`` — the stable string form used in snapshots."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram: ``counts[i]`` tallies observations with
    ``v <= edges[i]`` (exclusive of earlier buckets); the last slot is the
    +Inf overflow.  Edges are part of the snapshot, so a reader never has
    to guess the schema."""

    __slots__ = ("edges", "counts", "count", "total", "min", "max")

    def __init__(self, edges: Tuple[float, ...]) -> None:
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be sorted, got {edges!r}")
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper edge of the bucket the
        q-th observation falls in; +Inf bucket reports the observed max)."""
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.edges[i] if i < len(self.edges) else self.max
        return self.max


class MetricsRegistry:
    """Name+labels -> metric.  One process-wide instance (``registry()``)
    backs every instrumented layer; tests construct private ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Labels], Counter] = {}
        self._gauges: Dict[Tuple[str, Labels], Gauge] = {}
        self._histograms: Dict[Tuple[str, Labels], Histogram] = {}

    # -- get-or-create -----------------------------------------------------

    def _check_kind(self, name: str, kind: str) -> None:
        kinds = {"counter": self._counters, "gauge": self._gauges,
                 "histogram": self._histograms}
        for other, table in kinds.items():
            if other != kind and any(k[0] == name for k in table):
                raise ValueError(
                    f"metric {name!r} already registered as a {other}")

    def counter(self, name: str, **labels: object) -> Counter:
        key = (name, _labels_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.get(key)
                if c is None:
                    self._check_kind(name, "counter")
                    c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: object) -> Gauge:
        key = (name, _labels_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.get(key)
                if g is None:
                    self._check_kind(name, "gauge")
                    g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str,
                  edges: Tuple[float, ...] = DEFAULT_LATENCY_EDGES_US,
                  **labels: object) -> Histogram:
        key = (name, _labels_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.get(key)
                if h is None:
                    self._check_kind(name, "histogram")
                    h = self._histograms[key] = Histogram(edges)
        elif tuple(edges) != h.edges:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{h.edges}, got {tuple(edges)}")
        return h

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """A plain-dict, JSON-serializable snapshot with deterministic key
        order: ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``.
        Histogram entries carry their edges — the schema travels with the
        data."""
        counters = {render_key(n, ls): c.value
                    for (n, ls), c in sorted(self._counters.items())}
        gauges = {render_key(n, ls): g.value
                  for (n, ls), g in sorted(self._gauges.items())}
        hists = {}
        for (n, ls), h in sorted(self._histograms.items()):
            hists[render_key(n, ls)] = {
                "edges": list(h.edges),
                "counts": list(h.counts),
                "count": h.count,
                "sum": h.total,
                "min": None if h.count == 0 else h.min,
                "max": None if h.count == 0 else h.max,
            }
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def snapshot_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): dots in names become
        underscores, histograms emit cumulative ``_bucket`` series plus
        ``_sum``/``_count``."""
        out: List[str] = []

        def pname(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        def labelstr(labels: Labels, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in labels]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        def fmt(v: float) -> str:
            return repr(int(v)) if float(v).is_integer() else repr(float(v))

        typed = set()
        for (name, labels), c in sorted(self._counters.items()):
            if name not in typed:
                out.append(f"# TYPE {pname(name)} counter")
                typed.add(name)
            out.append(f"{pname(name)}{labelstr(labels)} {c.value}")
        for (name, labels), g in sorted(self._gauges.items()):
            if name not in typed:
                out.append(f"# TYPE {pname(name)} gauge")
                typed.add(name)
            out.append(f"{pname(name)}{labelstr(labels)} {fmt(g.value)}")
        for (name, labels), h in sorted(self._histograms.items()):
            if name not in typed:
                out.append(f"# TYPE {pname(name)} histogram")
                typed.add(name)
            cum = 0
            for edge, c in zip(h.edges, h.counts):
                cum += c
                le = 'le="%s"' % fmt(edge)
                out.append(f"{pname(name)}_bucket{labelstr(labels, le)} {cum}")
            cum += h.counts[-1]
            le_inf = 'le="+Inf"'
            out.append(f"{pname(name)}_bucket{labelstr(labels, le_inf)} {cum}")
            out.append(f"{pname(name)}_sum{labelstr(labels)} {fmt(h.total)}")
            out.append(f"{pname(name)}_count{labelstr(labels)} {h.count}")
        return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# The process-wide default registry + enable flag.
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()
_ENABLED = True


def registry() -> MetricsRegistry:
    """The process-wide registry every instrumented layer records into."""
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


def enable(flag: bool = True) -> bool:
    """Toggle metric collection process-wide; returns the previous value.
    Disabling turns every ``inc``/``set_gauge``/``observe``/``timed_span``
    into a no-op — results are bit-identical either way (tests/test_obs.py)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


def inc(name: str, n: int = 1, **labels: object) -> None:
    if _ENABLED:
        _REGISTRY.counter(name, **labels).inc(n)


def set_gauge(name: str, v: float, **labels: object) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name, **labels).set(v)


def observe(name: str, v: float,
            edges: Tuple[float, ...] = DEFAULT_LATENCY_EDGES_US,
            **labels: object) -> None:
    if _ENABLED:
        _REGISTRY.histogram(name, edges, **labels).observe(v)


# ---------------------------------------------------------------------------
# Snapshot arithmetic + human rendering.
# ---------------------------------------------------------------------------

def counter_deltas(new: dict, old: dict) -> Dict[str, int]:
    """Per-key counter difference between two snapshots (new keys count from
    zero); gauges/histograms are point-in-time and are not diffed here."""
    oldc = old.get("counters", {})
    return {k: v - oldc.get(k, 0) for k, v in new.get("counters", {}).items()}


def counter_total(counters: Dict[str, int], name: str) -> int:
    """Sum a (possibly labeled) counter family out of a snapshot or delta
    dict: exact-name match plus every ``name{...}`` labeled series."""
    prefix = name + "{"
    return sum(v for k, v in counters.items()
               if k == name or k.startswith(prefix))


def render_text(snapshot: dict, only: Optional[Iterable[str]] = None) -> str:
    """Compact human-readable snapshot dump (one metric per line)."""
    prefixes = tuple(only) if only else None

    def keep(k: str) -> bool:
        return prefixes is None or k.startswith(prefixes)

    lines: List[str] = []
    for k, v in snapshot.get("counters", {}).items():
        if keep(k):
            lines.append(f"{k} = {v}")
    for k, v in snapshot.get("gauges", {}).items():
        if keep(k):
            lines.append(f"{k} = {v:g}")
    for k, h in snapshot.get("histograms", {}).items():
        if not keep(k):
            continue
        if h["count"] == 0:
            lines.append(f"{k}: count=0")
            continue
        mean = h["sum"] / h["count"]
        hist = Histogram(tuple(h["edges"]))
        hist.counts = list(h["counts"])
        hist.count = h["count"]
        hist.max = h["max"]
        lines.append(
            f"{k}: count={h['count']} mean={mean:.1f}us "
            f"p50<={hist.quantile(0.5):g}us p99<={hist.quantile(0.99):g}us "
            f"max={h['max']:.1f}us")
    return "\n".join(lines)
