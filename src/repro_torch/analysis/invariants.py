"""The declarative invariant registry: DESIGN.md contract -> enforcing checks
(counterpart of ``repro/analysis/invariants.py``).

Each ``Invariant`` names one clause of the determinism contract and lists
the check codes (op_audit.CHECKS, lint.RULES and the audit's recapture and
coverage passes) that enforce it on the port.  The ids and ``design_ref``s
are the reference's; a summary says what the clause means where the torch
mechanism differs (a CUDA graph, cuBLAS, atomics, a host sync).  Findings
cite the invariant they break, so an AUDIT_REPORT line reads as "which
promise did this code violate", not just "which pattern matched".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .findings import Finding


@dataclasses.dataclass(frozen=True)
class Invariant:
    id: str
    design_ref: str
    summary: str
    checks: Tuple[str, ...]


INVARIANTS: Tuple[Invariant, ...] = (
    Invariant(
        id="INV-ARGS-NOT-CONSTS",
        design_ref="DESIGN.md §7.2",
        summary=(
            "Every corpus-scale or arbitrary-valued tensor (packed codes, "
            "qnorms, CSR, graph tables, masks, perm, predicate keys) is a "
            "stage ARGUMENT, never a closure constant: a CUDA graph bakes a "
            "closure tensor's address in and reads it on every replay, so "
            "the plan would pin (or, once freed, read) memory no index owns, "
            "and a host tensor converted inside a stage is a host-to-device "
            "copy a capture cannot hold.  Exempt: scalars, uniform fills, "
            "integer iotas and small tables, seeded ±1/0 factors (the RHDH "
            "signs and Hadamard blocks) and <= 16-entry float tables (the "
            "Lloyd-Max codebooks): the per-device caches of the kernels."),
        checks=("const-array", "stage-h2d"),
    ),
    Invariant(
        id="INV-CHUNKED-DOT",
        design_ref="DESIGN.md §5, §7.3",
        summary=(
            "Full-corpus float dots run in fixed 8-row query chunks "
            "(kernels/ref.py) or inside a hand-written kernel, which keeps "
            "each score one fixed f32 chain: a cuBLAS product picks its "
            "algorithm, and hence the last ulp, by shape, so any "
            "corpus-scale aten product on the card is a hazard.  "
            "Full-corpus float reductions outside that structure are "
            "flagged too."),
        checks=("full-scan-dot", "full-reduce"),
    ),
    Invariant(
        id="INV-NO-X64",
        design_ref="DESIGN.md §8",
        summary=(
            "No 64-bit float values inside a stage: scores and rotations "
            "stay f32, as in the reference, whose x64 is disabled.  int64 "
            "is exempt: it is torch's index dtype (topk, sort, gathers) and "
            "the port's predicate key planes are int64, compared exactly on "
            "every device; a float64 / complex128 tensor in a stage is a "
            "dtype-widening leak."),
        checks=("x64-leak",),
    ),
    Invariant(
        id="INV-NO-HOST-IN-TRACE",
        design_ref="DESIGN.md §9",
        summary=(
            "Host-side effects never enter a stage: no .item() / int() / "
            "bool() of a tensor or device-to-host copy (a capture cannot "
            "hold one, and on a replay it never runs), no live RNG op, no "
            "obs call or time.* read in a stage body (it runs once at "
            "capture and never on a replay; obs timers wrap the CALL to a "
            "plan, and bit-identity with tracing on and off is asserted on "
            "raw bytes)."),
        checks=("callback-prim", "rng-prim", "obs-in-stage", "host-time"),
    ),
    Invariant(
        id="INV-SEEDED-RANDOMNESS",
        design_ref="DESIGN.md §2, §6",
        summary=(
            "All randomness is seeded and replayable: stage-building "
            "modules never call unseeded random.* / np.random.* / torch "
            "RNG without a generator — segment seeds derive from (root, "
            "ordinal) and the RHDH sign stream from the header seed, so the "
            "same op sequence reproduces the same packed bytes on any "
            "device."),
        checks=("unseeded-random",),
    ),
    Invariant(
        id="INV-READER-VALIDATES",
        design_ref="DESIGN.md §6",
        summary=(
            ".mvec bytes are parsed only through mvec_format._Reader, which "
            "length-checks every block before np.frombuffer sees it; a "
            "frombuffer (numpy's or torch's) anywhere else can misparse a "
            "truncated file into silently-wrong (but deterministic-looking) "
            "arrays."),
        checks=("frombuffer-outside-reader",),
    ),
    Invariant(
        id="INV-ZERO-RETRACE",
        design_ref="DESIGN.md §7.1",
        summary=(
            "Same plan key ⇒ zero new plans and zero recaptures, and every "
            "stage reruns from its captured operands: the audit replays a "
            "small plan under torch.use_deterministic_algorithms(True) and "
            "fails on a plan-cache miss or capture on a warm bucket, on "
            "bytes that differ from the run with the flag off, and on an op "
            "with no deterministic implementation (atomics)."),
        checks=("unexpected-recapture", "stage-failure"),
    ),
    Invariant(
        id="INV-STAGE-COVERAGE",
        design_ref="DESIGN.md §10",
        summary=(
            "Every stage factory a module exports via PLAN_STAGES is "
            "actually captured by the audit grid — a new stage cannot ship "
            "outside the auditor's view."),
        checks=("uncovered-stage",),
    ),
)


_BY_CHECK: Dict[str, Invariant] = {
    check: inv for inv in INVARIANTS for check in inv.checks
}


def invariant_for_check(check: str) -> Optional[Invariant]:
    return _BY_CHECK.get(check)


def annotate(finding: Finding) -> Finding:
    """Return a copy of ``finding`` citing the invariant its check enforces."""
    inv = invariant_for_check(finding.check)
    if inv is None:
        return finding
    return dataclasses.replace(finding, invariant=inv.id,
                               design_ref=inv.design_ref)
