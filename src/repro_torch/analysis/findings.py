"""Structured findings, stable fingerprints, and the committed allowlist
(the port's own copy of ``repro/analysis/findings.py``).

A ``Finding`` is one detected violation of a determinism invariant: which
check fired, where (backend / stage / module), and a detail signature that
is STABLE across runs and machines — fingerprints hash only structural
fields (never shapes of the tiny audit corpora, object ids, or paths
outside the repo), so an allowlist entry accepted once keeps matching until
the underlying code actually changes what it stages.

The allowlist is a committed JSON file (``repro_torch/analysis/allowlist.json``).
Every entry must carry a human ``reason``; the audit treats a STALE entry
(an allowlisted fingerprint that no longer matches any finding) as a
failure in strict mode, so the allowlist cannot silently rot — and
tampering with it (adding entries that match nothing) fails CI.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One determinism-contract violation (or allowlist mismatch)."""

    check: str                    # e.g. "const-array" (op_audit.CHECKS)
    site: str                     # "<backend>/<stage>" or "<module>:<line>"
    detail: str                   # human-readable description
    signature: Tuple[str, ...]    # structural fields, the fingerprint input
    invariant: str = ""           # filled from invariants.py at report time
    design_ref: str = ""
    severity: str = "error"

    def fingerprint(self) -> str:
        return fingerprint(self.check, self.site, self.signature)

    def to_dict(self, allowlisted: bool = False) -> dict:
        return {
            "check": self.check,
            "site": self.site,
            "detail": self.detail,
            "signature": list(self.signature),
            "invariant": self.invariant,
            "design_ref": self.design_ref,
            "severity": self.severity,
            "fingerprint": self.fingerprint(),
            "allowlisted": allowlisted,
        }


def fingerprint(check: str, site: str, signature: Sequence[str]) -> str:
    """Stable 16-hex digest of a finding's structural identity."""
    payload = json.dumps([check, site, list(signature)], sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass
class Allowlist:
    """Accepted findings: fingerprint -> reason (the committed gate state)."""

    entries: Dict[str, str] = dataclasses.field(default_factory=dict)
    path: Optional[str] = None

    def match(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.entries

    def stale(self, findings: Sequence[Finding]) -> List[str]:
        """Fingerprints in the allowlist that matched NO finding — evidence
        of a fixed hazard (remove the entry) or a tampered file."""
        seen = {f.fingerprint() for f in findings}
        return sorted(fp for fp in self.entries if fp not in seen)


def load_allowlist(path: str) -> Allowlist:
    with open(path) as fh:
        payload = json.load(fh)
    entries: Dict[str, str] = {}
    for entry in payload.get("entries", []):
        fp = entry["fingerprint"]
        reason = entry.get("reason", "")
        if not reason:
            raise ValueError(
                f"allowlist entry {fp} has no reason; every accepted finding "
                f"must say why it is safe ({path})")
        entries[fp] = reason
    return Allowlist(entries=entries, path=path)


def render_report(
    findings: Sequence[Finding],
    allowlist: Allowlist,
    *,
    stale_is_error: bool = True,
    extra: Optional[dict] = None,
) -> dict:
    """The AUDIT_REPORT.json payload: findings split by allowlist state,
    stale allowlist entries surfaced, and an overall ``ok`` verdict."""
    active = [f for f in findings if not allowlist.match(f)]
    accepted = [f for f in findings if allowlist.match(f)]
    stale = allowlist.stale(findings)
    ok = not active and not (stale and stale_is_error)
    report = {
        "ok": ok,
        "counts": {
            "active": len(active),
            "allowlisted": len(accepted),
            "stale_allowlist": len(stale),
        },
        "findings": (
            [f.to_dict(allowlisted=False) for f in active]
            + [f.to_dict(allowlisted=True) for f in accepted]
        ),
        "stale_allowlist_entries": stale,
    }
    if extra:
        report.update(extra)
    return report
