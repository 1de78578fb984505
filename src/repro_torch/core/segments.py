"""Segment bookkeeping shared by every search path (subset of
``repro/core/segments.py``): the no-result sentinel and row -> id mapping.

External ids stay numpy uint64 on the host.  Segmented mutation (add,
delete, compact) is ROADMAP A4.
"""

from __future__ import annotations

import numpy as np

SENTINEL_ID = np.uint64(0xFFFFFFFFFFFFFFFF)


def rows_to_ids(rows: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Map row positions to external ids; negative rows -> SENTINEL_ID."""
    out = ids[np.maximum(rows, 0)].copy()
    out[rows < 0] = SENTINEL_ID
    return out
