"""``engine_host_ms.search``, read in the host-bound search cells.  A per-layer metric
names one end-to-end metric that it moves, and these cells report
``search_qps.host_bound`` (a bound of its own) instead of ``search_qps``:
hence a name of its own."""

from portbench.harness import cells

_BASE = cells.reader("engine_host_ms.search")
UNIT = _BASE.UNIT
read = _BASE.read
