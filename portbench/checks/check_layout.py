"""The benchmark's files agree with BENCHMARK.json and with the contract's
limits: every cell resolves to a configuration, a traffic mix of a kind
whose module has the runner's hooks, and metric readers that exist; names,
units and lines are in range; nothing under portbench/ is collected by a
bare ``python -m pytest``.

    python -m pytest -q -p no:cacheprovider portbench/checks/check_layout.py
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

import stand_in  # noqa: F401  (puts the checkout on the path)
from portbench.harness import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_NAMES = [w["name"] for w in SPEC["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + CELL_NAMES + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for item in SPEC["configs"] + SPEC["workloads"]:
        assert _line(item["why"]), item["name"]
    for c in SPEC["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])
    assert len(set(CELL_NAMES)) == len(CELL_NAMES)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_cell_resolves(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = cells.load(cell)
    spec = json.loads((BENCH / "cells" / f"{cell}.json").read_text())
    assert (spec["config"], spec["traffic"], spec["chips"]) == \
        (w["config"], w["traffic"], w["chips"]) == (c.config["name"], w["traffic"], 1)
    kind = cells.kind(c.traffic["kind"])
    for hook in ("run", "rows_done", "attempted", "outputs", "compare", "busy_s",
                 "device_ops", "idle_gaps"):
        assert callable(getattr(kind, hook, None)), (c.traffic["kind"], hook)
    cfg_entry = next(x for x in SPEC["configs"] if x["name"] == w["config"])
    assert (ROOT / cfg_entry["file"]).resolve() == (BENCH / "configs" /
                                                     f"{w['config']}.json").resolve()
    assert cfg_entry["source"] == c.config["source"] and cfg_entry["reduced"] == \
        c.config["reduced"]
    # The cell reports exactly the metrics BENCHMARK.json gives it.
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
    pl = [m["name"] for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])]
    assert sorted(c.end_to_end) == sorted(e2e) and sorted(c.per_layer) == sorted(pl)
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for metric in c.end_to_end + c.per_layer:
        assert cells.reader(metric).UNIT == units[metric], metric
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer


def test_per_layer_moves_and_layers():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", CELL_NAMES), (m["name"], cell)
        if "_roofline" in m["name"]:   # <kernel>_roofline, split as mfu.train is
            assert m["unit"] == "%" and m["name"].split(".")[0].endswith("_roofline")


def test_every_configuration_used_and_file_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).is_file()


def test_four_chip_share():
    fours = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert fours <= max(1, len(CELL_NAMES) // 4)


def test_nothing_collected_by_a_bare_pytest():
    for path in BENCH.rglob("*.py"):
        assert not path.name.startswith("test_") and not path.name.endswith("_test.py"), path
        assert path.name != "conftest.py", path


def test_file_names_are_made_of_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.name in (".gitignore", "README.md"):
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
