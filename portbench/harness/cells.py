"""Finds a cell's files by name: ``cells/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, data for the kind it names, whose code is
``traffic/<kind>.py``), the metrics it reports (each read by
``metrics/<metric>.py``) and the limits of its comparison with the
reference.  Adding a cell, a configuration, a mix, a kind or a metric adds
files; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: Dict[str, float]
    chips: int = 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, overrides: Optional[dict] = None) -> Cell:
    """The cell ``name``; ``overrides`` ({"config": {...}, "traffic": {...}})
    replace keys of its configuration and mix (the CPU rehearsals' sizes)."""
    path = BENCH / "cells" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no cell {name!r} (looked for {path})")
    spec = _json(path)
    config = _json(BENCH / "configs" / f"{spec['config']}.json")
    traffic = _json(BENCH / "traffic" / f"{spec['traffic']}.json")
    for part, target in (("config", config), ("traffic", traffic)):
        for key, value in ((overrides or {}).get(part) or {}).items():
            if isinstance(value, dict) and isinstance(target.get(key), dict):
                target[key] = {**target[key], **value}
            else:
                target[key] = value
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=list(spec["end_to_end"]), per_layer=list(spec["per_layer"]),
                limits=dict(spec["limits"]), chips=int(spec["chips"]))


def _module(kind: str, name: str) -> ModuleType:
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} (looked for {path})")
    mod_name = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str) -> ModuleType:
    """``traffic/<kind>.py``: a traffic kind's hooks (``harness/runner.py``)."""
    return _module("traffic", name)


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``: ``UNIT`` and ``read(ctx) -> float | None``."""
    return _module("metrics", metric)


def roofline(stage: str) -> ModuleType:
    """``roofline/<stage>.py``: ``work(...) -> (operations, bytes)``."""
    return _module("roofline", stage)
