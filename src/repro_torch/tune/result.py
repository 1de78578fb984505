"""Autotuning result types (a copy of ``repro/tune/result.py``; DESIGN.md
§12).

Plain data with no import of the port: ``TuneResult`` is persisted in the
``.mvec`` v11 TUNE block (``core.mvec_format``), rides on ``MonaVec.tuned``
and resolves into the engine's plan-key defaults (``engine.plan``), three
layers that name the type without an import cycle.

Determinism: every field is a pure function of (corpus bytes, tuning seed,
tuning parameters).  Recalls are exact hit-count ratios, never derived from
a clock; the chosen knob is the SMALLEST ladder rung whose measured recall
meets the target (cost is monotone in each knob, so the cheapest rung needs
no timing).  Saving the same tuned index twice, or tuning the same corpus
again under the same seed, gives byte-identical files.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KnobRung:
    """One measured point of a knob ladder sweep."""

    value: int                 # the knob setting (nprobe / ef / rescore_mult)
    recall: float              # exact recall@k vs the full-scan oracle


@dataclasses.dataclass(frozen=True)
class BoostPoint:
    """One tuned step of the selectivity boost curve."""

    selectivity: float         # probe selectivity this step was tuned at
    mult: int                  # knob multiplier chosen for that selectivity
    recall: float              # measured filtered recall@k at (mult, sel)


@dataclasses.dataclass(frozen=True)
class BoostCurve:
    """Step function: query selectivity -> candidate-budget multiplier.

    ``points`` are ascending in selectivity.  A query whose measured
    selectivity ``s`` falls at or below a breakpoint uses that breakpoint's
    multiplier (the curve tuned AT 1% is what a <=1% query needs); queries
    less selective than the largest breakpoint take no boost.
    """

    points: Tuple[BoostPoint, ...]

    def __post_init__(self) -> None:
        sels = [p.selectivity for p in self.points]
        if sels != sorted(sels):
            raise ValueError(
                f"boost curve breakpoints must ascend, got {sels}")

    def multiplier(self, selectivity: float) -> int:
        for p in self.points:
            if selectivity <= p.selectivity:
                return int(p.mult)
        return 1


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """The persisted outcome of one autotune run (``.mvec`` v11 TUNE block).

    ``knobs`` become the engine's plan-key DEFAULTS (precedence: explicit
    per-call kwarg > tuned knob > engine default — DESIGN.md §12);
    ``ladder`` records the full measured sweep so the choice is auditable;
    ``boost`` (optional) is the selectivity-aware candidate-budget curve.
    ``met_target`` is False when no ladder rung reached the target (the
    best-recall rung is chosen instead — HNSW graphs can cap below 1.0).
    """

    recall_target: float
    k: int
    n_queries: int
    seed: int
    met_target: bool
    knobs: Dict[str, int]
    ladder: Dict[str, Tuple[KnobRung, ...]]
    boost: Optional[BoostCurve] = None


__all__ = ["BoostCurve", "BoostPoint", "KnobRung", "TuneResult"]
