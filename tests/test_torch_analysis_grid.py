"""The port's audit grid and stage observer against the reference's, on the
CPU: the observer's semantics, ``PLAN_STAGES`` module by module, the
(backend, stage) sites the same grid points capture in both packages (and a
clean op audit of the port's), coverage, the recapture pass under
``torch.use_deterministic_algorithms`` and the CLI's hazard self-test.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import grid as ref_grid
from repro_torch import MonaVec
from repro_torch.analysis import audit_captures
from repro_torch.analysis import grid as t_grid
from repro_torch.analysis.audit import recapture_findings, run_audit
from repro_torch.engine import plan as plan_mod

ROOT = Path(__file__).resolve().parents[1]

# The grid points whose sites both packages must capture alike.
PARITY_POINTS = (
    "bruteforce/cosine/b4/static",
    "ivf/l2/b2/static",
    "hnsw/cosine/b4/static",
    "hybrid/cosine/b4/static+where",
    "cascade-sign/cosine/b4/static",
    "cascade-crumb/l2/b4/mutated+where",
    "sharded/cosine/b4/static",
    "ivf/cosine/b4/static+where+tuned",
)


def _point(grid_mod, label):
    return next(p for p in grid_mod.default_grid() if p.label == label)


def _sites(caps):
    return sorted({(c.backend, c.stage) for c in caps})


@pytest.mark.parametrize("label", PARITY_POINTS)
def test_grid_point_sites_equal_reference_and_audit_clean(label):
    ref_caps = ref_grid.collect_captures([_point(ref_grid, label)])
    caps = t_grid.collect_captures([_point(t_grid, label)], device="cpu")
    assert caps, "observer captured nothing — plan hook is broken"
    assert _sites(caps) == _sites(ref_caps)
    found = audit_captures(caps)
    assert found == [], [f.to_dict() for f in found]


def test_grid_shape_equals_reference():
    assert [p.label for p in t_grid.default_grid()] == \
        [p.label for p in ref_grid.default_grid()]
    assert (t_grid.N_BASE, t_grid.N_EXTRA, t_grid.DIM, t_grid.K, t_grid.BATCHES) == \
        (ref_grid.N_BASE, ref_grid.N_EXTRA, ref_grid.DIM, ref_grid.K, ref_grid.BATCHES)


@pytest.mark.parametrize("module", [m.split(".", 1)[1] for m in ref_grid.STAGE_MODULES])
def test_plan_stages_equal_reference(module):
    port = importlib.import_module(f"repro_torch.{module}")
    ref = importlib.import_module(f"repro.{module}")
    assert port.PLAN_STAGES == ref.PLAN_STAGES
    for name in port.PLAN_STAGES:
        assert callable(getattr(port, name))


def test_coverage_findings_on_empty_capture_set_equal_reference():
    got = {f.site.split(".", 1)[1] for f in t_grid.coverage_findings([])}
    want = {f.site.split(".", 1)[1] for f in ref_grid.coverage_findings([])}
    assert got == want and "core.hnsw:search_stage" in got
    assert all(f.check == "uncovered-stage" for f in t_grid.coverage_findings([]))


@pytest.mark.parametrize("index,kw,stages", [
    ("bruteforce", {}, {"rotate", "scan", "finalize"}),
    ("ivf", {"nlist": 4}, {"rotate", "main", "merge"}),
    ("hnsw", {"m": 4, "ef_construction": 16}, {"rotate", "main", "merge"}),
])
def test_observer_fires_on_cpu_searches_and_silences_when_cleared(index, kw, stages):
    x = np.random.RandomState(13).randn(40, 16).astype(np.float32)
    idx = MonaVec.build(x, index=index, device="cpu", **kw)
    seen = []
    prev = plan_mod.set_stage_observer(lambda kind, stage, fn, args: seen.append(stage))
    try:
        want = idx.search(x[:3], 4)
    finally:
        assert plan_mod.set_stage_observer(prev) is not None
    assert set(seen) == stages
    seen.clear()
    got = idx.search(x[:3], 4)                  # the cached plan, now silent
    assert seen == [] and got[1].tobytes() == want[1].tobytes()


def test_observer_silent_while_a_stream_captures(monkeypatch):
    """A stage run inside a CUDA graph capture reports nothing (a replay
    would never run the observer); the same search reports once the
    capture ends."""
    x = np.random.RandomState(15).randn(40, 16).astype(np.float32)
    idx = MonaVec.build(x, device="cpu")
    seen = []
    prev = plan_mod.set_stage_observer(lambda kind, stage, fn, args: seen.append(stage))
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        idx.search(x[:3], 4)
        assert seen == []
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        idx.search(x[:3], 4)
        assert set(seen) == {"rotate", "scan", "finalize"}
    finally:
        plan_mod.set_stage_observer(prev)


def test_observed_stages_rerun_to_the_same_bytes():
    """A capture's fn(*args) is the stage the plan ran: its rerun gives the
    plan's bytes (the finalize stage's top-k equals the search's)."""
    x = np.random.RandomState(14).randn(40, 16).astype(np.float32)
    idx = MonaVec.build(x, device="cpu")
    caps = []
    prev = plan_mod.set_stage_observer(lambda *a: caps.append(a))
    try:
        vals, _ = idx.search(x[:3], 4)
    finally:
        plan_mod.set_stage_observer(prev)
    kind, stage, fn, args = caps[-1]
    assert (kind, stage) == ("BruteForceIndex", "finalize")
    again, _ = fn(*args)
    assert again[:3].numpy().tobytes() == vals.tobytes()


def test_observer_restored_after_collect_even_on_error(monkeypatch):
    sentinel = lambda *a: None  # noqa: E731
    prev = plan_mod.set_stage_observer(sentinel)
    try:
        t_grid.collect_captures([t_grid.GridPoint(label="t/restore")], device="cpu")
        assert plan_mod._STAGE_OBSERVER is sentinel

        def boom(*a, **k):
            raise RuntimeError("boom")
        monkeypatch.setattr(t_grid, "_run_point", boom)
        with pytest.raises(RuntimeError, match="boom"):
            t_grid.collect_captures([t_grid.GridPoint(label="t/err")], device="cpu")
        assert plan_mod._STAGE_OBSERVER is sentinel
    finally:
        plan_mod.set_stage_observer(prev)
    assert plan_mod._STAGE_OBSERVER is prev


def test_collect_captures_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_grid.collect_captures([t_grid.GridPoint(label="t/card")])


@pytest.mark.parametrize("flag_before", [False, True])
def test_recapture_pass_clean_and_flag_restored(flag_before):
    torch.use_deterministic_algorithms(flag_before)
    try:
        assert recapture_findings("cpu") == []
        assert torch.are_deterministic_algorithms_enabled() is flag_before
    finally:
        torch.use_deterministic_algorithms(False)


def test_recapture_pass_flags_unstable_cache(monkeypatch):
    real = plan_mod.PlanCache.get_or_build

    def always_miss(self, key, make):
        self.stats.misses += 1
        return make()
    monkeypatch.setattr(plan_mod.PlanCache, "get_or_build", always_miss)
    found = recapture_findings("cpu")
    monkeypatch.setattr(plan_mod.PlanCache, "get_or_build", real)
    assert [f.check for f in found] == ["unexpected-recapture"]
    assert not torch.are_deterministic_algorithms_enabled()


def test_full_audit_on_cpu_is_clean():
    report = run_audit(device="cpu")
    assert report["ok"], [f for f in report["findings"] if not f["allowlisted"]]
    assert report["counts"]["active"] == 0 and report["counts"]["stale_allowlist"] == 0
    assert report["grid_points"] == 21 and report["captures"] > 50
    assert report["environment"] == {"torch": torch.__version__, "device": "cpu"}
    assert set(report["launches"]) == {f"B{i}" for i in range(1, 8)}


def test_cli_inject_hazard_exits_nonzero_naming_both(tmp_path):
    report_path = tmp_path / "AUDIT_REPORT.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--device", "cpu",
         "--inject-hazard", "--quiet", "--report", str(report_path)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "const-array" in proc.stdout and "full-scan-dot" in proc.stdout
    report = json.loads(report_path.read_text())
    assert not report["ok"]
    assert {f["check"] for f in report["findings"]} == {"const-array", "full-scan-dot"}
    assert all(f["invariant"] for f in report["findings"])
