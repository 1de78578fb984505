"""The port's determinism audit against the reference's (``repro.analysis``),
on identical inputs, on the CPU.

Parity: fingerprints, reports, invariant ids and design refs, the const
exemption policy, and the lint of the reference test's L001 / L002 snippets
equal the reference's; the injected hazard's two findings carry the
reference's fingerprints.  Then the port's own checks, positive and
negative: ``obs-in-stage`` and ``stage-h2d`` (the torch counterparts of
L003 / L004), and every op-audit check on small stages.
"""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import findings as ref_findings
from repro.analysis import invariants as ref_invariants
from repro.analysis import jaxpr_audit as ref_ja
from repro.analysis import lint as ref_lint
from repro.analysis.audit import inject_hazard_capture as ref_hazard
from repro_torch.analysis import (Allowlist, Finding, StageCapture, audit_captures,
                                  fingerprint, invariant_for_check, load_allowlist,
                                  render_report)
from repro_torch.analysis import invariants as t_invariants
from repro_torch.analysis import lint as t_lint
from repro_torch.analysis import op_audit
from repro_torch.analysis.audit import DEFAULT_ALLOWLIST, inject_hazard_capture


def _audit_fn(fn, *args, n_corpus=0, backend="Unit", stage="stage"):
    cap = StageCapture(backend=backend, stage=stage, fn=fn, args=args,
                       context={"n_corpus": n_corpus})
    return audit_captures([cap])


def _checks(found):
    return sorted({f.check for f in found})


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Findings, reports, invariants: equal to the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check,site,signature", [
    ("const-array", "X/scan", ("const-array", "float-array[float32]", "ndim=2")),
    ("full-scan-dot", "SelfTest/injected_hazard", ("full-scan-dot", "float32")),
    ("host-time", "core/x.py:f", ("host-time", "time.time")),
    ("uncovered-stage", "core.hnsw:search_stage", ()),
])
def test_fingerprint_equals_reference(check, site, signature):
    fp = fingerprint(check, site, signature)
    assert fp == ref_findings.fingerprint(check, site, signature)
    assert fp == fingerprint(check, site, list(signature)) and len(fp) == 16


def test_render_report_equals_reference():
    rows = [("const-array", "A/scan", "d1", ("const-array", "x")),
            ("full-reduce", "B/main", "d2", ("full-reduce", "float32")),
            ("host-time", "core/y.py:g", "d3", ("host-time", "time.monotonic"))]
    port = [Finding(check=c, site=s, detail=d, signature=g) for c, s, d, g in rows]
    ref = [ref_findings.Finding(check=c, site=s, detail=d, signature=g) for c, s, d, g in rows]
    entries = {port[1].fingerprint(): "accepted", "f" * 16: "stale"}
    for strict in (True, False):
        got = render_report(port, Allowlist(entries=dict(entries)), stale_is_error=strict,
                            extra={"mode": "full"})
        want = ref_findings.render_report(ref, ref_findings.Allowlist(entries=dict(entries)),
                                          stale_is_error=strict, extra={"mode": "full"})
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_invariant_ids_and_design_refs_equal_reference():
    got = [(i.id, i.design_ref) for i in t_invariants.INVARIANTS]
    want = [(i.id, i.design_ref) for i in ref_invariants.INVARIANTS]
    assert got == want


def test_every_check_maps_to_one_invariant():
    seen = {}
    for inv in t_invariants.INVARIANTS:
        for check in inv.checks:
            assert check not in seen, f"check {check} claimed by two invariants"
            seen[check] = inv.id
    for check in op_audit.CHECKS + t_lint.RULES + (
            "stage-failure", "unexpected-recapture", "uncovered-stage"):
        assert invariant_for_check(check) is not None, check
    assert seen["const-array"] == "INV-ARGS-NOT-CONSTS"
    assert seen["unexpected-recapture"] == "INV-ZERO-RETRACE"


def test_allowlist_reason_is_mandatory(tmp_path):
    p = tmp_path / "a.json"
    p.write_text(json.dumps({"entries": [{"fingerprint": "ab" * 8}]}))
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(str(p))


def test_stale_entry_fails_strict_report_and_match_passes():
    allow = Allowlist(entries={"f" * 16: "bogus tamper entry"})
    report = render_report([], allow, stale_is_error=True)
    assert not report["ok"] and report["stale_allowlist_entries"] == ["f" * 16]
    assert render_report([], allow, stale_is_error=False)["ok"]
    f = Finding(check="c", site="s", detail="d", signature=("c", "x"))
    report = render_report([f], Allowlist(entries={f.fingerprint(): "accepted"}))
    assert report["ok"] and report["counts"] == {"active": 0, "allowlisted": 1,
                                                 "stale_allowlist": 0}


def test_committed_allowlist_loads_with_reasons():
    allow = load_allowlist(DEFAULT_ALLOWLIST)
    assert all(allow.entries.values()), "every entry carries a reason"


# ---------------------------------------------------------------------------
# The const exemption policy: the reference's cases, numpy and torch inputs.
# ---------------------------------------------------------------------------

EXEMPT = [
    np.float32(3.0),
    np.zeros(5, np.float32),
    np.full((64,), 7.0, np.float32),
    np.arange(100, dtype=np.int32),
    np.arange(5, 105, dtype=np.int32),
    np.random.RandomState(0).randint(0, 9, 100),
    np.sign(np.random.RandomState(0).randn(256)).astype(np.float32),
    np.linspace(-2, 2, 16).astype(np.float32),
]
FLAGGED = [
    (np.random.RandomState(0).randn(64, 16).astype(np.float32), "float-array[float32]"),
    (np.random.RandomState(0).randn(17).astype(np.float32), "float-array[float32]"),
    (np.random.RandomState(0).randint(0, 9, 2048).astype(np.int32), "int-array[int32]"),
]


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("value", EXEMPT)
def test_classify_const_exempt_as_reference(value, as_tensor):
    assert ref_ja._classify_const(value) is None
    assert op_audit._classify_const(_t(value) if as_tensor else value) is None


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("value,cls", FLAGGED)
def test_classify_const_flagged_as_reference(value, cls, as_tensor):
    assert ref_ja._classify_const(value) == cls
    assert op_audit._classify_const(_t(value) if as_tensor else value) == cls


# ---------------------------------------------------------------------------
# Lint: the reference's L001 / L002 snippets give equal findings.
# ---------------------------------------------------------------------------

SNIPPETS = {
    "unseeded": ("core/thing.py", """
        import random
        import numpy as np

        def build(seed):
            rng = np.random.RandomState(seed)      # idiom: allowed
            gen = np.random.default_rng(seed)      # allowed
            a = np.random.randn(4)                 # global RNG: flagged
            b = random.random()                    # stdlib: flagged
            return rng, gen, a, b
    """),
    "host-time-core": ("core/thing.py", """
        import time

        def f():
            return time.perf_counter()
    """),
    "host-time-launch": ("launch/serve.py", """
        import time

        def f():
            return time.perf_counter()
    """),
    "injected-clock": ("core/tenancy.py", """
        import time
        import dataclasses

        @dataclasses.dataclass
        class Limiter:
            clock = time.monotonic
    """),
    "frombuffer-reader": (os.path.join("core", "mvec_format.py"), """
        import numpy as np

        class _Reader:
            def take(self, b):
                return np.frombuffer(b, dtype=np.uint8)

        def rogue(b):
            return np.frombuffer(b, dtype=np.uint8)
    """),
    "frombuffer-other": ("core/other.py", """
        import numpy as np

        class _Reader:
            def take(self, b):
                return np.frombuffer(b, dtype=np.uint8)

        def rogue(b):
            return np.frombuffer(b, dtype=np.uint8)
    """),
}


def _lint_both(tmp_path, rel, src):
    path = tmp_path / os.path.basename(rel)
    path.write_text(textwrap.dedent(src))
    port = t_lint.lint_file(str(path), rel)
    ref = ref_lint.lint_file(str(path), rel)
    return port, ref


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_l001_l002_snippets_equal_reference(tmp_path, name):
    rel, src = SNIPPETS[name]
    port, ref = _lint_both(tmp_path, rel, src)
    assert [(f.check, f.site, f.fingerprint()) for f in port] == \
        [(f.check, f.site, f.fingerprint()) for f in ref]
    expect = {"unseeded": 2, "host-time-core": 1, "host-time-launch": 0,
              "injected-clock": 0, "frombuffer-reader": 1, "frombuffer-other": 2}[name]
    assert len(port) == expect


def test_lint_fingerprints_do_not_move_with_lines(tmp_path):
    src = "import time\n\ndef f():\n    return time.time()\n"
    shifted = "import time\n\n\n# comment\n\ndef f():\n    return time.time()\n"
    (tmp_path / "a.py").write_text(src)
    (tmp_path / "b.py").write_text(shifted)
    fa = t_lint.lint_file(str(tmp_path / "a.py"), "core/x.py")
    fb = t_lint.lint_file(str(tmp_path / "b.py"), "core/x.py")
    assert [f.fingerprint() for f in fa] == [f.fingerprint() for f in fb]
    assert [f.fingerprint() for f in fa] == \
        [f.fingerprint() for f in ref_lint.lint_file(str(tmp_path / "a.py"), "core/x.py")]


def _lint(tmp_path, rel, src):
    return _lint_both(tmp_path, rel, src)[0]


def test_unseeded_torch_rng_flagged_generator_allowed(tmp_path):
    src = """
        import torch

        def build(seed, n):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(n, generator=g)           # seeded: allowed
            b = torch.randperm(n)                      # global generator: flagged
            torch.manual_seed(seed)                    # seeds the global one: flagged
            return a, b, torch.randint(0, 9, (n,), generator=g)
    """
    found = _lint(tmp_path, "core/thing.py", src)
    assert [f.signature for f in found] == [("unseeded-random", "torch.randperm"),
                                            ("unseeded-random", "torch.manual_seed")]
    assert _lint(tmp_path, "data/thing.py", src) == []


def test_obs_in_stage_plan_stages_and_build_plan_closures(tmp_path):
    src = """
        from repro_torch import obs

        PLAN_STAGES = ("scan_stage",)

        def scan_stage(q):
            obs.inc("n")                 # a stage body: flagged
            def inner(x):
                return obs.timed_span("s")   # inside a stage: flagged
            return inner(q)

        def host_path(q):
            obs.inc("fine")              # not a stage: allowed
            return q
    """
    found = _lint(tmp_path, "core/thing.py", src)
    assert [(f.check, f.site) for f in found] == [
        ("obs-in-stage", "core/thing.py:scan_stage"),
        ("obs-in-stage", "core/thing.py:scan_stage.inner")]
    plan_src = """
        from repro_torch import obs

        def _build_plan(backend):
            obs.inc("plans")             # the plan factory itself: allowed
            def fn(q):
                obs.observe("x", 1.0)    # a plan closure: flagged
                return q
            return fn

        class _Graph:
            def replay(self, call):
                obs.inc("replays")       # outside every stage: allowed
    """
    found = _lint(tmp_path, os.path.join("engine", "plan.py"), plan_src)
    assert [(f.check, f.site) for f in found] == [
        ("obs-in-stage", "engine/plan.py:_build_plan.fn")]
    assert _lint(tmp_path, os.path.join("engine", "other.py"), plan_src) == []


def test_stage_h2d_of_captured_names(tmp_path):
    src = """
        import numpy as np
        import torch

        PLAN_STAGES = ("bad", "good")
        table = np.arange(4)
        corpus = None

        def bad(q, dev):
            a = torch.from_numpy(table)          # captured: flagged
            b = corpus.to(dev)                   # captured: flagged
            c = corpus.cuda()                    # captured: flagged
            return q, a, b, c

        def good(q, c, host):
            local = torch.as_tensor(host)        # argument: allowed
            moved = local.to(q.device)           # local: allowed
            cast = corpus.to(torch.int32)        # dtype only: allowed
            return moved, cast, torch.tensor(c)
    """
    found = _lint(tmp_path, "core/thing.py", src)
    assert [(f.site, f.signature[1]) for f in found] == [
        ("core/thing.py:bad", "torch.from_numpy(table)"),
        ("core/thing.py:bad", "corpus.to()"),
        ("core/thing.py:bad", "corpus.cuda()")]
    assert {f.check for f in found} == {"stage-h2d"}


# ---------------------------------------------------------------------------
# The op audit, check by check.
# ---------------------------------------------------------------------------

def test_injected_hazard_raises_both_with_the_reference_fingerprints():
    port = audit_captures([inject_hazard_capture("cpu")])
    assert _checks(port) == ["const-array", "full-scan-dot"]
    ref = ref_ja.audit_captures([ref_hazard()])
    assert sorted(f.fingerprint() for f in port) == sorted(f.fingerprint() for f in ref)
    assert {f.invariant for f in port} == {"INV-ARGS-NOT-CONSTS", "INV-CHUNKED-DOT"}


def test_full_scan_dot_as_argument_still_flagged():
    assert _checks(_audit_fn(lambda q, c: q @ c.T, torch.zeros(12, 16),
                             torch.zeros(64, 16), n_corpus=64)) == ["full-scan-dot"]


def test_chunked_dot_is_clean():
    from repro_torch.kernels import ref
    assert _audit_fn(ref._chunked_dot, torch.zeros(12, 16), torch.zeros(16, 64),
                     n_corpus=64) == []


def test_small_dot_not_corpus_scale():
    assert _audit_fn(lambda q, c: q @ c.T, torch.zeros(12, 16), torch.zeros(8, 16),
                     n_corpus=64) == []


def test_gathered_batched_product_is_clean():
    def fn(deq, q):
        return torch.einsum("bmd,bd->bm", deq, q)
    assert _audit_fn(fn, torch.zeros(3, 70, 16), torch.zeros(3, 16), n_corpus=64) == []
    from repro_torch.kernels import ref
    packed = torch.zeros(64, 8, dtype=torch.uint8)
    cand = torch.arange(12 * 64, dtype=torch.int32).reshape(12, 64) % 64
    assert _audit_fn(ref.gather_nibble_dot_ref, packed, torch.zeros(12, 16), cand,
                     n_corpus=64) == []


def test_full_reduce_flagged_chunked_reduce_not():
    assert _checks(_audit_fn(lambda s: torch.sum(s, dim=-1), torch.zeros(3, 128),
                             n_corpus=64)) == ["full-reduce"]
    assert _audit_fn(lambda s: torch.sum(s, dim=-1), torch.zeros(8, 128), n_corpus=64) == []
    assert _audit_fn(lambda s: torch.sum(s, dim=-1), torch.zeros(3, 16), n_corpus=64) == []


def test_x64_float_flagged_int64_not():
    assert _checks(_audit_fn(lambda x: x.double() * 2.0, torch.zeros(4))) == ["x64-leak"]
    assert _audit_fn(lambda x: torch.topk(x, 2).indices.long() + 1, torch.zeros(4)) == []


def test_rng_op_flagged():
    assert _checks(_audit_fn(lambda x: x * torch.randn(16), torch.zeros(3, 16))) \
        == ["rng-prim"]


def test_host_read_flagged():
    assert _checks(_audit_fn(lambda x: x.sum().item(), torch.zeros(3, 4))) \
        == ["callback-prim"]
    assert _checks(_audit_fn(lambda x: int(x.argmax()), torch.zeros(3, 4))) \
        == ["callback-prim"]


def test_stage_that_raises_is_a_finding():
    def broken():
        raise RuntimeError("boom")
    found = audit_captures([StageCapture(backend="Unit", stage="s", fn=broken, args=())])
    assert _checks(found) == ["stage-failure"]
    assert found[0].invariant == "INV-ZERO-RETRACE"


def test_lineage_follows_views_copies_and_outputs():
    big = torch.from_numpy(np.random.RandomState(1).randn(64, 16).astype(np.float32))

    def fn(x):
        v = x[:, :8].t().contiguous()          # views and copies of an argument
        return (v.to(torch.float64).float() * 2).sum()
    assert _checks(_audit_fn(fn, big)) == ["x64-leak"]
    rec = op_audit.record_stage(StageCapture("U", "s", lambda x: x + big[:2], (big[:2],)))
    assert rec.consts == []                    # a view's storage is the argument's


def test_module_caches_are_exempt_by_value():
    """The sign proxy's byte-popcount table, the bit weights, the Lloyd-Max
    codebook and the RHDH signs are per-device module constants: each is
    read as a constant and exempt by the copied policy."""
    from repro_torch.core import binary, quantize as qz
    from repro_torch.core.rhdh import rhdh_apply
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(48, 16).astype(np.float32))
    enc = binary.attach_coarse(qz.encode(x, metric="cosine", seed=3, bits=4), "sign")
    q_rot = rhdh_apply(x[:12], 3, normalized=False)
    cap = StageCapture("U", "coarse_scan",
                       lambda q, c: binary.coarse_scan_stage(q, c, kind="sign"),
                       (q_rot, enc.ccodes), {"n_corpus": 48})
    rec = op_audit.record_stage(cap)
    assert rec.consts and all(op_audit._classify_const(c) is None for c in rec.consts)
    assert op_audit.audit_ops(rec, cap) == []
    scan = StageCapture("U", "scan", lambda q, p: binary.ops.score_raw(p, q, bits=4),
                        (q_rot, enc.packed), {"n_corpus": 48})
    assert audit_captures([scan]) == []
    rot = StageCapture("U", "rotate", lambda q: rhdh_apply(q, 3, normalized=False),
                       (x[:12],), {"n_corpus": 48})
    assert audit_captures([rot]) == []


def test_kernel_counters_read_around_a_rerun(monkeypatch):
    from repro_torch.kernels import nibble_dot

    def fake_kernel(x):
        nibble_dot.nibble_dot_cuda.launches += 1
        return x + 1
    monkeypatch.setattr(nibble_dot.nibble_dot_cuda, "launches", 5)
    cap = StageCapture("U", "scan", fake_kernel, (torch.zeros(3),))
    assert audit_captures([cap]) == [] and cap.context["launches"] == {"B1": 1}


# ---------------------------------------------------------------------------
# The tree.
# ---------------------------------------------------------------------------

def test_repo_tree_lint_matches_allowlist_exactly():
    found = t_lint.lint_tree()
    allow = load_allowlist(DEFAULT_ALLOWLIST)
    assert [f for f in found if not allow.match(f)] == [], \
        "new lint findings: fix them or allowlist with a reason"
    assert allow.stale(found) == []
    assert {f.check for f in found} <= {"obs-in-stage"}
