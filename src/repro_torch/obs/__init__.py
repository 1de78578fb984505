# repro_torch.obs — engine-wide observability (DESIGN.md §9; a copy of the
# JAX package's observability module, which the port may not import): the process-wide
# MetricsRegistry (counters / gauges / fixed-bucket latency histograms with
# deterministic edges), the QueryTrace span API with host-side timers that
# never enter a traced function (and device spans from CUDA timing events on
# one clock with them, with the device's idle time by cause), and the
# DeltaStats snapshot/since mixin.
#
# Instrumentation is additive by contract: a metrics-enabled or traced
# search returns bytes identical to a disabled one (tests/test_obs.py).

from .registry import (DEFAULT_COUNT_EDGES, DEFAULT_LATENCY_EDGES_US,
                       Counter, Gauge, Histogram, MetricsRegistry,
                       counter_deltas, counter_total, enable, enabled, inc,
                       observe, registry, render_key, render_text, set_gauge)
from .stats import DeltaStats
from .trace import (CALLER, DEVICE, HOST, IDLE_HISTOGRAM, WAIT, QueryTrace,
                    Span, Tracer, clock, current_trace, idle_stretches, span,
                    timed_span, trace, wait_span)

__all__ = [
    "CALLER", "DEFAULT_COUNT_EDGES", "DEFAULT_LATENCY_EDGES_US", "DEVICE",
    "HOST", "IDLE_HISTOGRAM", "WAIT",
    "Counter", "DeltaStats", "Gauge", "Histogram", "MetricsRegistry",
    "QueryTrace", "Span", "Tracer",
    "clock", "counter_deltas", "counter_total", "current_trace", "enable",
    "enabled", "idle_stretches", "inc", "observe", "registry", "render_key",
    "render_text", "set_gauge", "span", "timed_span", "trace", "wait_span",
]
