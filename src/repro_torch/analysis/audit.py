"""``python -m repro_torch.analysis.audit`` — the port's determinism audit
(counterpart of ``repro/analysis/audit.py``).

    python -m repro_torch.analysis.audit [--device cuda|cpu] [--report PATH]
        [--allowlist PATH] [--inject-hazard] [--skip-retrace] [--skip-lint]
        [--quiet]

One run = four passes, one report, one exit code:

1. **grid**      — drive the real engine over the backend × metric × bits ×
   lifecycle grid (analysis/grid.py) on ``--device`` (the card unless the
   CPU is asked for), capture every stage through the plan observer, and
   rerun each under the op recorder (analysis/op_audit.py);
2. **coverage**  — every PLAN_STAGES export must have been witnessed;
3. **recapture** — build and warm a small plan, then replay the same bucket
   3 times, all under ``torch.use_deterministic_algorithms(True)`` (the
   counterpart of ``jax.checking_leaks``): the plan cache's misses and
   captures must not move, the bytes must equal a run with the flag off,
   and an op without a deterministic implementation is a finding; the flag
   is restored on exit;
4. **lint**      — the AST source rules (analysis/lint.py).

Findings are matched against the committed allowlist
(``src/repro_torch/analysis/allowlist.json``); the report (AUDIT_REPORT.json)
lists active, allowlisted, and STALE entries — a stale entry fails the run,
so the allowlist cannot rot.

``--inject-hazard`` swaps the grid for one deliberately broken synthetic
stage (closure-captured corpus + a full-scan product outside the 8-row
chunk) and must exit non-zero naming BOTH hazards: the gate can fail.

Under ``torch.use_deterministic_algorithms(True)`` a cuBLAS call on the
card needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before
its handle exists; set it when starting the process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .findings import Allowlist, Finding, load_allowlist, render_report
from .invariants import annotate
from .op_audit import StageCapture, audit_captures

DEFAULT_ALLOWLIST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "allowlist.json")


def inject_hazard_capture(device: str = "cuda") -> StageCapture:
    """A stage written exactly the way stages must NOT be written: the
    corpus rides in the closure (const-array) and the scoring product runs
    over the whole corpus outside the 8-row chunk (full-scan-dot)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(0xBAD)
    bad_corpus = torch.from_numpy(rng.randn(64, 16).astype(np.float32)).to(dev)

    def hazardous_stage(q: torch.Tensor) -> torch.Tensor:
        return q @ bad_corpus.T

    q = torch.from_numpy(rng.randn(12, 16).astype(np.float32)).to(dev)
    return StageCapture(
        backend="SelfTest", stage="injected_hazard",
        fn=hazardous_stage, args=(q,),
        context={"n_corpus": 64, "label": "self-test/injected",
                 "labels": ["self-test/injected"]})


def recapture_findings(device: str = "cuda") -> List[Finding]:
    """INV-ZERO-RETRACE: build and warm a plan under
    ``torch.use_deterministic_algorithms(True)``, then replay the same
    bucket: the plan cache's misses and captures must not move, every
    result must equal the bytes of the same search with the flag off, and
    no op may raise for want of a deterministic implementation."""
    from ..core.api import MonaVec
    from ..engine import plan as plan_mod

    rng = np.random.RandomState(99)
    vecs = rng.randn(40, 16).astype(np.float32)
    q = rng.randn(3, 16).astype(np.float32)
    stats = plan_mod.plan_cache().stats
    was_on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    out: List[Finding] = []
    try:
        torch.use_deterministic_algorithms(False)
        want = MonaVec.build(vecs, metric="cosine", bits=4, seed=0xA11CE,
                             device=device).search(q, k=4)
        torch.use_deterministic_algorithms(True)
        idx = MonaVec.build(vecs, metric="cosine", bits=4, seed=0xA11CE, device=device)
        got = [idx.search(q, k=4)]                     # cold: plans and captures here
        before = (stats.misses, stats.captures)
        for _ in range(3):
            got.append(idx.search(q + np.float32(0.0), k=4))   # warm, same bucket
        after = (stats.misses, stats.captures)
    except Exception as exc:
        out.append(annotate(Finding(
            check="stage-failure", site="engine/plan",
            detail=f"a plan raised under torch.use_deterministic_algorithms(True): {exc}",
            signature=("stage-failure", type(exc).__name__))))
        return out
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=warn_only)
    if after != before:
        out.append(annotate(Finding(
            check="unexpected-recapture", site="engine/plan",
            detail=(f"{after[0] - before[0]} plan-cache miss(es) and "
                    f"{after[1] - before[1]} capture(s) on warm same-bucket "
                    f"searches — the plan cache key or the graph store is "
                    f"unstable"),
            signature=("unexpected-recapture", "warm-bucket"))))
    if any(v.tobytes() != want[0].tobytes() or i.tobytes() != want[1].tobytes()
           for v, i in got):
        out.append(annotate(Finding(
            check="stage-failure", site="engine/plan",
            detail="a search under torch.use_deterministic_algorithms(True) "
                   "returned other bytes than the same search with the flag off",
            signature=("stage-failure", "bytes-differ-under-flag"))))
    return out


def _environment(device: str) -> dict:
    from ..device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"torch": torch.__version__, "device": name}


def run_audit(
    *,
    device: str = "cuda",
    inject_hazard: bool = False,
    skip_retrace: bool = False,
    skip_lint: bool = False,
    allowlist_path: str = DEFAULT_ALLOWLIST,
    progress: bool = False,
) -> dict:
    """Execute the full audit on ``device``; returns the report dict (see
    render_report), with ``environment`` and, for the grid, ``captures``,
    ``grid_points``, ``launches`` (each kernel's launches over the grid's
    searches) and ``rerun_launches`` (over the audited stage reruns)."""
    say = (lambda msg: print(msg, file=sys.stderr, flush=True)) if progress \
        else (lambda msg: None)

    findings: List[Finding] = []
    extra: dict = {"mode": "inject-hazard" if inject_hazard else "full"}

    if inject_hazard:
        say("auditing injected hazardous stage (gate self-test)")
        findings.extend(audit_captures([inject_hazard_capture(device)]))
    else:
        from . import grid as grid_mod
        from .op_audit import kernel_counts

        say(f"collecting stage captures over the audit grid on {device}")
        before = kernel_counts()
        captures = grid_mod.collect_captures(
            progress=(lambda label: say(f"  grid point: {label}")), device=device)
        after = kernel_counts()
        say(f"auditing {len(captures)} captured stages")
        findings.extend(audit_captures(captures))
        findings.extend(grid_mod.coverage_findings(captures))
        extra["captures"] = len(captures)
        extra["grid_points"] = len(grid_mod.default_grid())
        extra["launches"] = {k: after[k] - before[k] for k in after}
        extra["rerun_launches"] = grid_mod.grid_launches(captures)
        if not skip_retrace:
            say("recapture pass (torch.use_deterministic_algorithms)")
            findings.extend(recapture_findings(device))
        if not skip_lint:
            from .lint import lint_tree

            say("AST lint pass")
            findings.extend(lint_tree())

    allow = (load_allowlist(allowlist_path)
             if os.path.exists(allowlist_path) else Allowlist())
    # The injected-hazard mode audits ONE synthetic stage; the allowlist
    # still applies (so a tampered allowlist cannot mask the self-test) but
    # its real entries are necessarily stale there — ignore staleness.
    report = render_report(findings, allow,
                           stale_is_error=not inject_hazard, extra=extra)
    report["environment"] = _environment(device)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="op-level determinism audit over the stage grid")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the grid's indexes live (default: the card)")
    parser.add_argument("--report", default="AUDIT_REPORT.json",
                        help="path for the JSON report ('-' for stdout only)")
    parser.add_argument("--allowlist", default=DEFAULT_ALLOWLIST)
    parser.add_argument("--inject-hazard", action="store_true",
                        help="audit a deliberately hazardous synthetic stage "
                             "instead of the grid; MUST exit non-zero")
    parser.add_argument("--skip-retrace", action="store_true",
                        help="skip the recapture pass")
    parser.add_argument("--skip-lint", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    report = run_audit(
        device=args.device,
        inject_hazard=args.inject_hazard,
        skip_retrace=args.skip_retrace,
        skip_lint=args.skip_lint,
        allowlist_path=args.allowlist,
        progress=not args.quiet,
    )

    if args.report != "-":
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    for f in report["findings"]:
        mark = "ALLOWED" if f["allowlisted"] else "ERROR  "
        print(f"{mark} {f['check']:26s} {f['site']}  [{f['invariant']}]")
        print(f"        {f['detail']}")
    for fp in report["stale_allowlist_entries"]:
        print(f"STALE   allowlist entry {fp} matched no finding — remove it "
              f"(or the audit was tampered with)")
    counts = report["counts"]
    verdict = "OK" if report["ok"] else "FAIL"
    print(f"{verdict}: {counts['active']} active, "
          f"{counts['allowlisted']} allowlisted, "
          f"{counts['stale_allowlist']} stale allowlist entries")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
