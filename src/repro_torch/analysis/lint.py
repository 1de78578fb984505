"""AST-level repo invariant linter — the source rules a stage run cannot see
(counterpart of ``repro/analysis/lint.py``).

The op auditor proves properties of what a stage actually RAN; this module
proves properties of what was WRITTEN, catching hazards before they are
reachable from any grid point:

* ``unseeded-random``          (L001) — ``random.*`` / bare ``np.random.*``
  calls, and torch's global-generator draws (``torch.rand*``,
  ``torch.randint``, ``torch.randperm``, ... without ``generator=``;
  ``torch.manual_seed``), in stage-building modules (core / engine / dist /
  kernels / tune): all index randomness must flow from seeded generators
  (``np.random.RandomState(s)`` / ``np.random.default_rng(s)``) so builds
  replay byte-identically.
* ``host-time``                (L001) — ``time.*()`` calls in those same
  modules: wall-clock reads belong to obs/ and launch/, never near stage
  construction (a clock INJECTED as a parameter default is fine; a call is
  not).
* ``frombuffer-outside-reader`` (L002) — ``np.frombuffer`` or
  ``torch.frombuffer`` anywhere except ``mvec_format._Reader``, the one
  place that length-checks bytes first.
* ``obs-in-stage``             (L003) — ``obs.inc`` / ``obs.observe`` /
  ``obs.timed_span`` / ``get_registry`` / ``histogram`` inside a stage body:
  on the card a stage runs once at capture and then only as a graph replay,
  so host-side observability there counts once and never again.
* ``stage-h2d``                (L004) — ``torch.tensor`` /
  ``torch.as_tensor`` / ``torch.from_numpy``, ``.to(<device>)`` or
  ``.cuda()`` of a closure-captured name inside a stage body: a host copy a
  capture cannot hold, or a captured tensor the graph reads at a fixed
  address (the runtime twin is op_audit's const-array check).

A stage body is a function a module names in its ``PLAN_STAGES``, or one
defined inside it, or a closure that ``engine/plan.py``'s ``_build_plan*``
functions define.  ``engine/plan.py``'s ``_Graph`` copies its inputs in
before a replay outside every stage, by design, and is no stage body.

Findings carry line numbers in ``detail`` but NOT in their fingerprint
(site is ``path:qualname``), so unrelated edits above a finding do not
invalidate allowlist entries.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Set

from .findings import Finding
from .invariants import annotate

#: Directories (relative to src/repro_torch) whose modules build stages or bytes.
STAGE_BUILDING_DIRS = ("core", "engine", "dist", "kernels", "tune")
#: The one sanctioned frombuffer site.
READER_MODULE = os.path.join("core", "mvec_format.py")
READER_CLASS = "_Reader"
#: The module whose ``_build_plan*`` closures are stage bodies.
PLAN_MODULE = os.path.join("engine", "plan.py")
PLAN_FACTORY_PREFIX = "_build_plan"

_OBS_CALLS = {"inc", "observe", "timed_span", "get_registry", "histogram"}
_TIME_CALLS = {"time", "monotonic", "perf_counter", "process_time",
               "thread_time", "clock_gettime"}
_SEEDED_FACTORIES = {"RandomState", "default_rng", "Generator", "SeedSequence"}
#: torch draws from (or seeds) the global generator unless given generator=.
_TORCH_RNG = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal", "bernoulli", "multinomial",
              "poisson"}
_H2D_FACTORIES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
_DTYPE_NAMES = {"float32", "float64", "float16", "bfloat16", "half", "float",
                "double", "int8", "int16", "int32", "int64", "int", "long",
                "short", "uint8", "bool", "complex64", "complex128"}

RULES = ("unseeded-random", "host-time", "frombuffer-outside-reader",
         "obs-in-stage", "stage-h2d")


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'np.random.randint' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _plan_stages(tree: ast.Module) -> Set[str]:
    """The names in a module-level ``PLAN_STAGES = (...)`` tuple."""
    names: Set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "PLAN_STAGES"
                        for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            names.update(e.value for e in node.value.elts
                         if isinstance(e, ast.Constant) and isinstance(e.value, str))
    return names


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters + names assigned anywhere inside ``fn`` (so only true
    closure captures count as 'free' for stage-h2d)."""
    args = fn.args
    names = {a.arg for a in (
        list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs))}
    for extra in (args.vararg, args.kwarg):
        if extra is not None:
            names.add(extra.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn:
                names.add(node.name)
    return names


def _dtype_only(call: ast.Call) -> bool:
    """``x.to(torch.int32)`` / ``x.to(dtype=...)``: a conversion on the
    tensor's own device, no copy between devices."""
    if any(kw.arg == "device" for kw in call.keywords):
        return False
    if call.args:
        chain = _attr_chain(call.args[0]) or ""
        return chain.startswith("torch.") and chain.split(".")[-1] in _DTYPE_NAMES
    return any(kw.arg == "dtype" for kw in call.keywords)


def _finding(rule: str, rel: str, qualname: str, line: int, call: str,
             detail: str) -> Finding:
    return annotate(Finding(
        check=rule,
        site=f"{rel}:{qualname}" if qualname else rel,
        detail=f"{rel}:{line}: {detail}",
        signature=(rule, call),
    ))


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.findings: List[Finding] = []
        self.stage_building = any(
            rel.startswith(d + os.sep) for d in STAGE_BUILDING_DIRS)
        self.is_reader_module = rel == READER_MODULE
        self.is_plan_module = rel == PLAN_MODULE
        self._stage_names = _plan_stages(tree)
        self._class_stack: List[str] = []
        self._fn_stack: List["ast.FunctionDef | ast.AsyncFunctionDef"] = []
        self._stage_depth = 0

    # -- context tracking --------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _is_stage(self, node: "ast.FunctionDef | ast.AsyncFunctionDef") -> bool:
        top_level = not self._fn_stack and not self._class_stack
        if top_level and node.name in self._stage_names:
            return True
        return (self.is_plan_module and len(self._fn_stack) >= 1
                and not self._class_stack
                and self._fn_stack[0].name.startswith(PLAN_FACTORY_PREFIX))

    def _visit_fn(
        self, node: "ast.FunctionDef | ast.AsyncFunctionDef",
    ) -> None:
        stage = self._is_stage(node)
        self._fn_stack.append(node)
        self._stage_depth += 1 if stage else 0
        self.generic_visit(node)
        self._stage_depth -= 1 if stage else 0
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    @property
    def _qualname(self) -> str:
        parts = list(self._class_stack) + [f.name for f in self._fn_stack]
        return ".".join(parts)

    # -- the rules ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func) or ""
        self._rule_l001(node, chain)
        self._rule_l002(node, chain)
        self._rule_l003(node, chain)
        self._rule_l004(node, chain)
        self.generic_visit(node)

    def _rule_l001(self, node: ast.Call, chain: str) -> None:
        if not self.stage_building:
            return
        if chain.startswith("random."):
            self.findings.append(_finding(
                "unseeded-random", self.rel, self._qualname, node.lineno,
                chain,
                f"stdlib '{chain}(...)' in a stage-building module — all "
                f"randomness must come from a seeded generator"))
        elif chain.startswith(("np.random.", "numpy.random.")):
            leaf = chain.rsplit(".", 1)[1]
            if leaf in _SEEDED_FACTORIES and node.args:
                return          # np.random.RandomState(seed) — the idiom
            self.findings.append(_finding(
                "unseeded-random", self.rel, self._qualname, node.lineno,
                chain,
                f"'{chain}(...)' draws from (or seeds without an explicit "
                f"seed) the GLOBAL numpy RNG in a stage-building module"))
        elif chain == "torch.manual_seed" or (
                chain.startswith("torch.") and chain.count(".") == 1
                and chain.split(".")[1] in _TORCH_RNG
                and not any(kw.arg == "generator" for kw in node.keywords)):
            self.findings.append(_finding(
                "unseeded-random", self.rel, self._qualname, node.lineno,
                chain,
                f"'{chain}(...)' draws from (or seeds) torch's GLOBAL "
                f"generator in a stage-building module — pass a seeded "
                f"generator="))
        elif chain.startswith("time.") and chain.split(".")[1] in _TIME_CALLS:
            self.findings.append(_finding(
                "host-time", self.rel, self._qualname, node.lineno, chain,
                f"wall-clock read '{chain}()' in a stage-building module — "
                f"clocks live in obs/ and launch/, or arrive injected"))

    def _rule_l002(self, node: ast.Call, chain: str) -> None:
        if not chain.endswith("frombuffer"):
            return
        if self.is_reader_module and READER_CLASS in self._class_stack:
            return
        self.findings.append(_finding(
            "frombuffer-outside-reader", self.rel, self._qualname,
            node.lineno, chain,
            f"'{chain}' outside mvec_format.{READER_CLASS} — raw bytes are "
            f"parsed only through the length-checked reader"))

    def _rule_l003(self, node: ast.Call, chain: str) -> None:
        if self._stage_depth <= 0:
            return
        parts = chain.split(".")
        if ((len(parts) >= 2 and parts[0] == "obs"
             and parts[-1] in _OBS_CALLS)
                or parts[-1] == "timed_span"
                or chain == "get_registry"):
            self.findings.append(_finding(
                "obs-in-stage", self.rel, self._qualname, node.lineno, chain,
                f"observability call '{chain}(...)' inside a stage body: on "
                f"the card it runs once at capture and never on a replay"))

    def _rule_l004(self, node: ast.Call, chain: str) -> None:
        if self._stage_depth <= 0 or not self._fn_stack:
            return
        local = _local_names(self._fn_stack[-1])
        if chain in _H2D_FACTORIES:
            if not node.args or not isinstance(node.args[0], ast.Name):
                return
            name, call = node.args[0].id, f"{chain}({node.args[0].id})"
        elif (isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and (node.func.attr == "cuda"
                   or (node.func.attr == "to" and not _dtype_only(node)))):
            name = node.func.value.id
            call = f"{name}.{node.func.attr}()"
        else:
            return
        if name in local:
            return
        self.findings.append(_finding(
            "stage-h2d", self.rel, self._qualname, node.lineno, call,
            f"'{call}' moves the closure-captured '{name}' inside a stage "
            f"body — a host-to-device copy a capture cannot hold, or an "
            f"address the graph bakes in; pass it as a stage argument"))


def lint_file(path: str, rel: str) -> List[Finding]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    linter = _ModuleLinter(rel, tree)
    linter.visit(tree)
    return linter.findings


def lint_tree(root: Optional[str] = None) -> List[Finding]:
    """Lint every module under src/repro_torch (analysis excluded — it is
    the checker, and its only 'violations' are the patterns it documents)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "analysis"))
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            findings.extend(lint_file(path, rel))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json as _json

    from .findings import Allowlist, load_allowlist, render_report

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST invariant linter over src/repro_torch")
    default_allow = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "allowlist.json")
    parser.add_argument("--allowlist", default=default_allow)
    parser.add_argument("--root", default=None,
                        help="package root to lint (default: src/repro_torch)")
    args = parser.parse_args(argv)

    allow = (load_allowlist(args.allowlist)
             if os.path.exists(args.allowlist) else Allowlist())
    findings = lint_tree(args.root)
    # Lint shares the audit allowlist but must not call ITS unmatched
    # entries stale — the op checks own those.
    report = render_report(findings, allow, stale_is_error=False)
    for f in report["findings"]:
        mark = "ALLOWED" if f["allowlisted"] else "ERROR  "
        print(f"{mark} {f['check']:26s} {f['site']}\n        {f['detail']}")
    active = report["counts"]["active"]
    print(_json.dumps({"ok": active == 0, "counts": report["counts"]}))
    return 0 if active == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
