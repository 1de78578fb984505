"""On the card only (marked ``card``; each skips inside the test without
one): every cell's command, a short window, exits 0 with ``correct`` true,
and an empty directory's copy of the harness alone exits non-zero.

    python -m pytest -q -p no:cacheprovider -o markers=card \
        portbench/checks/check_card.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import stand_in

ROOT = Path(__file__).resolve().parents[2]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", stand_in.CELLS)
def test_cell_on_the_card(cell):
    _need_card()
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.card
def test_harness_alone_refuses(tmp_path):
    _need_card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", stand_in.CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and not out.stdout.strip()
