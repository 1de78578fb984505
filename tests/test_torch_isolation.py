"""The PyTorch port stands alone: no JAX and nothing of ``repro`` in the
package or in ``chip_smoke.py``; it imports with JAX blocked; its entry
points run on the card unless the CPU is asked for; its CUDA wrappers import
without nvcc and build nothing until called.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import MonaVec
from repro_torch.kernels import cuda_build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.kernels import (binary_dot, cuda_build, gather_dot, hadamard,\n"
        "                                 nibble_dot, ops, ref)\n"
        "from repro_torch import obs\n"
        "from repro_torch.engine import batcher, plan\n"
        "from repro_torch.core import (binary, convert, ivf, metadata, mvec_format, predicate,\n"
        "                              segments, tenancy)\n"
        "from repro_torch.data import synthetic\n"
        "x = synthetic.embedding_corpus(0, 64, 24)\n"
        "s, i = repro_torch.MonaVec.build(x, device='cpu').search(x[:2], 3)\n"
        "assert i[0, 0] == 0 and i[1, 0] == 1\n"
        "idx = repro_torch.MonaVec.build(x, coarse='crumb', device='cpu')\n"
        "s, i = idx.search(x[:2], 3, rescore_mult=2)\n"
        "assert i[0, 0] == 0 and i[1, 0] == 1\n"
        "new = idx.add(synthetic.embedding_corpus(1, 16, 24))\n"
        "assert idx.delete([0, int(new[0])]) == 2 and idx.n_live == 78\n"
        "s, i = idx.searcher(k=3, rescore_mult=2).warmup(2)(x[:2])\n"
        "assert 0 not in i.tolist() and i[1, 0] == 1\n"
        "reg = tenancy.TenantRegistry()\n"
        "reg.put('t', 'c', idx)\n"
        "t = batcher.MicroBatcher(reg).submit('t', 'c', x[1:2], k=3)\n"
        "assert t.result()[1][0, 0] == 1 and obs.registry().snapshot()['counters']\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "f = repro_torch.MonaVec.build(x, index='ivf', nlist=4, meta={'g': np.arange(64) % 2},\n"
        "                              device='cpu')\n"
        "s, i = f.search(x[:2], 3, nprobe=4, where=predicate.Eq('g', 0))\n"
        "assert i[0, 0] == 0 and (i % 2 == 0).all()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MonaVec.build(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MonaVec.build(x, coarse="sign")
    path = str(tmp_path / "a.mvec")
    MonaVec.build(x, device="cpu").save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MonaVec.load(path)
    assert MonaVec.load(path, device="cpu").device.type == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    assert cuda_build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["hadamard", "nibble_dot", "binary_dot", "gather_dot"])


@pytest.mark.parametrize("name", ["hadamard", "nibble_dot", "binary_dot", "gather_dot"])
def test_kernel_sources_name_what_they_replace(name):
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert "Replaces the Pallas kernel src/repro/kernels/" in text
    assert 'extern "C"' in text and "cudaGetLastError" in text
    assert cuda_build.library_path(name).parent == cuda_build.BUILD_DIR


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
