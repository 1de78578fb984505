"""Every cell end to end on the CPU at a tiny size, through the same files
(stand_in.py): the result line's keys, ``correct``, the metrics each run
reports, and the import guard after it.

    python -m pytest -q -p no:cacheprovider portbench/checks/check_rehearsal.py
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest

import stand_in
from portbench.harness import cells, env

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", stand_in.CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    res = stand_in.run(cell, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    json.dumps(res)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    c = cells.load(cell)
    want = set(c.per_layer if trace else c.end_to_end) - (stand_in.CARD_ONLY if trace else set())
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        assert m["unit"] == cells.reader(name).UNIT
    assert set(res["checks"]) == set(c.limits)
    # Nothing of JAX or of the JAX package was loaded on the way.
    assert env.forbidden_modules() == []


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & set(env.FORBIDDEN), (path, tops & set(env.FORBIDDEN))


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert "repro_torch" not in tops and "portbench" not in tops - {"portbench"}, path
        text = path.read_text()
        assert "repro_torch" not in text, path


def test_guard_compares_whole_top_level_names():
    import sys
    import types

    sys.modules["repro_torch_lookalike"] = types.ModuleType("repro_torch_lookalike")
    try:
        assert env.forbidden_modules() == []
        sys.modules["repro.core"] = types.ModuleType("repro.core")
        assert env.forbidden_modules() == ["repro"]
    finally:
        sys.modules.pop("repro_torch_lookalike", None)
        sys.modules.pop("repro.core", None)
