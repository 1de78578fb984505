"""The readers of the program's own trace (``metrics/submit_ms.*``,
``queue_wait_ms.*``, ``stage_*_ms.*``, ``idle_in_program_ms.*``, through
``harness/spans.py``): each reads a value in a traced CPU rehearsal of the
search cells it is written for (stand_in.py, the stages timed by the host
clock there), and nothing where the program has no such span.  No cell
lists them yet (``spans.READERS``); the rehearsal adds them to the cell's
list.

    python -m pytest -q -p no:cacheprovider portbench/checks/check_trace_readers.py
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

import stand_in
from portbench.harness import cells, spans

READERS = spans.READERS


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_read_in_a_traced_rehearsal(cell, monkeypatch):
    from repro_torch import obs

    load = cells.load

    def with_readers(name, overrides=None):
        c = load(name, overrides)
        return dataclasses.replace(c, per_layer=c.per_layer + READERS[name])

    monkeypatch.setattr(cells, "load", with_readers)
    obs.registry().reset()      # one run a process on the card; here, a fresh registry
    res = stand_in.run(cell, trace=True)
    assert res["correct"] is True, res["checks"]
    for name in READERS[cell]:
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] > 0 and \
            res["metrics"][name]["unit"] == cells.reader(name).UNIT == "ms"


def test_readers_read_nothing_without_the_programs_spans():
    from repro_torch import obs

    obs.registry().reset()
    rounds = [{"submit": 1e-3, "flush": 2e-3, "results": 1e-4,
               "spans": {"plan_lookup": 1e-5, "execute": 1e-3, "sync": 1e-4,
                         "batcher.execute": 1.5e-3, "batcher.scatter": 1e-5}}]
    ctx = SimpleNamespace(win={"rounds": rounds}, port=SimpleNamespace(obs=obs),
                          cell=SimpleNamespace(traffic={"clients": 4}))
    for names in READERS.values():
        for name in names:
            assert cells.reader(name).read(ctx) is None, name
