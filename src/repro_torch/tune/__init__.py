# Training-free autotuning (counterpart of ``repro/tune``; DESIGN.md §12):
# recall-targeted knob selection persisted in the .mvec (v11 TUNE block), and
# exact predicate-selectivity counts driving the engine's filtered
# candidate-budget boost.
#
# Import shape: result.py is plain data (core.mvec_format and engine.plan
# name TuneResult without a cycle); autotune.py drives the engine;
# selectivity.py counts a predicate's rows on the index's device.

from .autotune import autotune, knob_ladder, measure_recall, sample_queries
from .result import BoostCurve, BoostPoint, KnobRung, TuneResult
from .selectivity import clear_caches, estimate_matches, make_popcount_fn

__all__ = [
    "BoostCurve", "BoostPoint", "KnobRung", "TuneResult",
    "autotune", "clear_caches", "estimate_matches", "knob_ladder",
    "make_popcount_fn", "measure_recall", "sample_queries",
]
