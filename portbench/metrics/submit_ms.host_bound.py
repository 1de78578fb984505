"""``submit_ms.search``, read in the host-bound search cells, which report
``search_qps.host_bound`` (the end-to-end metric this one moves there)
in place of ``search_qps``."""

from portbench.harness import cells

_BASE = cells.reader("submit_ms.search")
UNIT = _BASE.UNIT
read = _BASE.read
