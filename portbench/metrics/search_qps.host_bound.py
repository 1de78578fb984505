"""``search_qps``, read in the host-bound search cells: a metric of its own
so that its bound follows their runs' spread (the host's Python is half of
a round there), not the device-bound cells', whose bound is tighter."""

from portbench.harness import cells

_BASE = cells.reader("search_qps")
UNIT = _BASE.UNIT
read = _BASE.read
