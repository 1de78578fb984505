"""Shared delta-window arithmetic for ad-hoc counter dataclasses.

``PlanStats`` and ``BatcherStats`` (repro_torch.engine) each grew identical
``snapshot()``/``since()`` methods for measuring a serving window; this is
the one implementation both now inherit.  Any all-numeric dataclass gets
the same contract by subclassing:

    @dataclasses.dataclass
    class MyStats(DeltaStats):
        hits: int = 0

    before = stats.snapshot()
    ...
    window = stats.since(before)     # field-wise difference, same type
"""

from __future__ import annotations

import dataclasses


class DeltaStats:
    """Mixin for ``@dataclass`` counter bundles: field-wise copy and diff."""

    def snapshot(self):
        """An immutable-by-convention copy of the current counter values."""
        return dataclasses.replace(self)

    def since(self, before):
        """Field-wise ``self - before``, returned as the same stats type."""
        if type(before) is not type(self):
            raise TypeError(
                f"since() expects a {type(self).__name__} snapshot, "
                f"got {type(before).__name__}")
        return type(self)(**{
            f.name: getattr(self, f.name) - getattr(before, f.name)
            for f in dataclasses.fields(self)})
