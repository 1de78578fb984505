# repro_torch.analysis: the port's machine-checked determinism contract
# (counterpart of repro.analysis).
#
# MonaVec's headline guarantee — byte-identical results within a build —
# rests on invariants that on the card mean: tensors are stage arguments,
# never closure constants (a CUDA graph bakes their addresses in); every
# corpus-scale product is a hand-written kernel or a fixed 8-row chunk (a
# cuBLAS product picks its algorithm by shape); no host effect inside a
# stage (an .item() or a copy to the host runs once at capture and never on
# a replay); seeded randomness only; one length-checked reader; zero
# recaptures on a warm bucket.  This package checks them mechanically:
#
#   * op_audit    — reruns every registered plan stage, as the engine's
#                   stage observer captured it, under a recording
#                   TorchDispatchMode and flags hazards in its aten ops;
#   * grid        — drives the real engine over a backend × metric × bits ×
#                   lifecycle grid under the observer, and checks coverage;
#   * invariants  — the declarative registry mapping each contract clause
#                   to the checks that enforce it;
#   * lint        — AST-level source rules a stage run cannot see;
#   * audit       — the CLI (`python -m repro_torch.analysis.audit`)
#                   emitting AUDIT_REPORT.json against the committed
#                   allowlist.

from .findings import (Allowlist, Finding, fingerprint, load_allowlist,
                       render_report)
from .invariants import INVARIANTS, Invariant, invariant_for_check
from .op_audit import StageCapture, audit_captures, audit_ops

__all__ = [
    "Allowlist", "Finding", "INVARIANTS", "Invariant", "StageCapture",
    "audit_captures", "audit_ops", "fingerprint", "invariant_for_check",
    "load_allowlist", "render_report",
]
