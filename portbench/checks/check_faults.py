"""``correct`` comes out false for the control and for each fault a cell can
have, planted in the program underneath a tiny CPU run (stand_in.py):

* the control: the reference at TF32 in the program's place;
* half of the batch left out: the second half of a search's rows (or of a
  build's rows) answered with the first half's;
* an answer altered where it is produced: an id, a score, a code byte;
* an answer that changes between repeats of one query or one build.

(A step that returns its state unchanged is a training fault, and no cell
here exchanges anything between chips.)

    python -m pytest -q -p no:cacheprovider portbench/checks/check_faults.py
"""

from __future__ import annotations

import itertools

import pytest
import torch

import stand_in

SEARCH = ("cohere1m.scan.c64x4", "agnews45k.scan.c64x8", "cohere1m.sign32.c64x4")


@pytest.mark.parametrize("cell", stand_in.CELLS)
def test_control_is_not_correct(cell):
    assert stand_in.verdict(cell, stand_in.readings(cell, control=False))
    assert not stand_in.verdict(cell, stand_in.readings(cell, control=True))


def _topk_fault(kind):
    from repro_torch.engine import plan

    original = plan.topk
    calls = itertools.count()

    def faulty(scores, k):
        vals, idx = original(scores, k)
        vals, idx = vals.clone(), idx.clone()
        if kind == "half":
            h = vals.shape[0] // 2
            vals[h:2 * h], idx[h:2 * h] = vals[:h], idx[:h]
        elif kind == "id":
            idx[:, 0] = (idx[:, 0] + 1) % scores.shape[1]
        elif kind == "score":
            vals[:, 0] = vals[:, 0] * 1.01
        elif kind == "repeat" and next(calls) % 2:
            vals[:, 0] = torch.nextafter(vals[:, 0], torch.tensor(float("inf")))
        return vals, idx
    return plan, "topk", faulty


def _survivor_fault():
    from repro_torch.core import binary

    original = binary.survivor_topk_stage

    def faulty(proxy, live, *, m):
        cand = original(proxy, live, m=m).clone()
        h = cand.shape[0] // 2
        cand[h:2 * h] = cand[:h]
        return cand
    return binary, "survivor_topk_stage", faulty


def _pack_fault(kind):
    from repro_torch.core import quantize

    original = quantize.pack_4bit
    calls = itertools.count()

    def faulty(codes):
        packed = original(codes).clone()
        if kind == "half":
            h = packed.shape[0] // 2
            packed[h:2 * h] = packed[:h]
        elif kind == "byte" or (kind == "repeat" and next(calls) % 2):
            packed[0, 0] ^= 1
        return packed
    return quantize, "pack_4bit", faulty


FAULTS = [(cell, kind) for cell in SEARCH for kind in ("half", "id", "score", "repeat")]
FAULTS += [("cohere1m.sign32.c64x4", "survivors_half")]
FAULTS += [("cohere1m.build", kind) for kind in ("half", "byte", "repeat")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_fault_is_not_correct(cell, kind, monkeypatch):
    if cell.endswith(".build"):
        mod, name, fn = _pack_fault(kind)
    elif kind == "survivors_half":
        mod, name, fn = _survivor_fault()
    else:
        mod, name, fn = _topk_fault(kind)
    monkeypatch.setattr(mod, name, fn)
    res = stand_in.run(cell, seconds=0.6)
    assert res["correct"] is False, res["checks"]
