# repro_torch.obs — engine-wide observability (DESIGN.md §9; a copy of the
# JAX package's observability module, which the port may not import): the process-wide
# MetricsRegistry (counters / gauges / fixed-bucket latency histograms with
# deterministic edges), the QueryTrace span API with host-side timers that
# never enter a traced function, and the DeltaStats snapshot/since mixin.
#
# Instrumentation is additive by contract: a metrics-enabled or traced
# search returns bytes identical to a disabled one (tests/test_obs.py).

from .registry import (DEFAULT_COUNT_EDGES, DEFAULT_LATENCY_EDGES_US,
                       Counter, Gauge, Histogram, MetricsRegistry,
                       counter_deltas, counter_total, enable, enabled, inc,
                       observe, registry, render_key, render_text, set_gauge)
from .stats import DeltaStats
from .trace import (QueryTrace, Span, Tracer, current_trace, span, timed_span,
                    trace)

__all__ = [
    "DEFAULT_COUNT_EDGES", "DEFAULT_LATENCY_EDGES_US",
    "Counter", "DeltaStats", "Gauge", "Histogram", "MetricsRegistry",
    "QueryTrace", "Span", "Tracer",
    "counter_deltas", "counter_total", "current_trace", "enable", "enabled",
    "inc", "observe", "registry", "render_key", "render_text", "set_gauge",
    "span", "timed_span", "trace",
]
