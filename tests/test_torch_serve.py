"""The port's serving CLI (``python -m repro_torch.launch.serve``) on the CPU
against the reference's (``repro.launch.serve``).

For each flag set the port's ``main([...,"--device", "cpu"])`` and the
reference's ``main()`` (``sys.argv`` patched) run in-process at n 2,000 (HNSW
1,000), d 64, two batches a phase, and each saves its index.  The two files,
loaded back, hold equal codes, ids, tombstones, metadata columns and TUNE
knobs, and qnorms within rtol 2.6e-7 (ROADMAP C).  Both print the same
phases; every measured window of the port's shows 0 misses and 0 captures;
its metrics JSON parses and holds the engine's stage histograms (and the
sharded search's with ``--shard``); a reload reports the tuned knobs.  Each
flag conflict exits with the reference's message.
"""

import json
import re
import sys

import numpy as np
import pytest

from repro.core import MonaVec as RefMonaVec
from repro.launch import serve as rserve
from repro_torch import MonaVec
from repro_torch.launch import serve
from tests.torch_harness import port_stream, reference_stream

QNORM_RTOL = 2.6e-7

_SETS = {
    "lifecycle": (2000, ["--filter-every", "8", "--mutate", "--compact", "--micro-batch", "8",
                         "--trace-sample", "5", "--metrics-json", "{d}/m.json",
                         "--metrics-prom", "{d}/m.prom", "--save", "{d}/f.mvec"]),
    "shard_cascade": (2000, ["--shard", "--filter-every", "8", "--coarse", "sign",
                             "--rescore-mult", "8", "--metrics-json", "{d}/m.json",
                             "--save", "{d}/f.mvec"]),
    "ivf_autotune": (2000, ["--index", "ivf", "--autotune", "--recall-target", "0.95",
                            "--save", "{d}/f.mvec"]),
    "hnsw": (1000, ["--index", "hnsw", "--save", "{d}/f.mvec"]),
    "shard": (2000, ["--shard", "--save", "{d}/f.mvec"]),
}


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _argv(n: int, flags, d) -> list:
    return ["--n", str(n), "--dim", "64", "--batches", "2"] + [f.format(d=d) for f in flags]


def _run_port(argv, capsys) -> str:
    serve.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _run_reference(argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    rserve.main()
    return capsys.readouterr().out


def _phases(out: str) -> list:
    return re.findall(r"\[serve\] (\w+): \d+ queries", out)


def _segments(idx):
    return ([(idx.backend.enc, idx.backend.ids, idx.mut.base_tombs)]
            + [(s.enc, s.ids, s.tombs) for s in idx.mut.extras])


def _assert_same_file(port_path, ref_path):
    got, want = MonaVec.load(port_path, device="cpu"), RefMonaVec.load(ref_path)
    assert type(got.backend).__name__ == type(want.backend).__name__
    assert len(_segments(got)) == len(_segments(want))
    for (ge, gi, gt), (we, wi, wt) in zip(_segments(got), _segments(want)):
        np.testing.assert_array_equal(ge.packed.numpy(), np.asarray(we.packed))
        np.testing.assert_allclose(ge.qnorms.numpy(), np.asarray(we.qnorms), rtol=QNORM_RTOL)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
        assert ge.seed == we.seed and ge.coarse == we.coarse
        if we.ccodes is not None:
            np.testing.assert_array_equal(ge.ccodes.numpy(), np.asarray(we.ccodes))
    assert (got.meta is None) == (want.meta is None)
    if want.meta is not None:
        assert got.meta.schema == want.meta.schema
        for name, _ in want.meta.schema:
            np.testing.assert_array_equal(got.meta[name].values, want.meta[name].values)
    assert (got.tuned is None) == (want.tuned is None)
    if want.tuned is not None:
        assert got.tuned.knobs == want.tuned.knobs
    return got


@pytest.mark.parametrize("name", list(_SETS))
def test_cli_matches_reference(name, tmp_path, capsys, monkeypatch):
    n, flags = _SETS[name]
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    out = _run_port(_argv(n, flags, tmp_path / "port"), capsys)
    ref_out = _run_reference(_argv(n, flags, tmp_path / "ref"), capsys, monkeypatch)
    assert _phases(out) == _phases(ref_out) and _phases(out)
    windows = re.findall(r"plan cache hits=(\d+) misses=(\d+) captures=(\d+)", out)
    assert len(windows) == len(_phases(out))
    assert all(int(h) > 0 and m == "0" and c == "0" for h, m, c in windows)
    got = _assert_same_file(tmp_path / "port" / "f.mvec", tmp_path / "ref" / "f.mvec")
    if "--metrics-json" in flags:
        hist = json.loads((tmp_path / "port" / "m.json").read_text())["histograms"]
        assert any(k.startswith("engine.stage_us{") for k in hist)
        if "--shard" in flags:      # the registry is the process's: absence is not checked
            assert any(k.startswith("dist.search_us{") for k in hist)
    if "--metrics-prom" in flags:
        assert "plan_cache_hits" in (tmp_path / "port" / "m.prom").read_text()
    if "--trace-sample" in flags:
        assert "[trace]   batch:static" in out
    if "--shard" in flags:
        assert f"[serve] sharded {n} rows over 1 local device(s)" in out
    if "--autotune" in flags:
        # The reload serves at the tuned knobs.
        reload = _run_port(["--load", str(tmp_path / "port" / "f.mvec"), "--batches", "2"],
                           capsys)
        assert f"[serve] static: knobs={got.tuned.knobs} (tuned)" in reload


def _no_meta_files(tmp_path):
    x = np.random.RandomState(3).randn(64, 16).astype(np.float32)
    MonaVec.build(x, device="cpu").save(str(tmp_path / "plain.mvec"))
    MonaVec.build(x, index="ivf", nlist=4, device="cpu").save(str(tmp_path / "ivf.mvec"))
    return tmp_path / "plain.mvec", tmp_path / "ivf.mvec"


_CONFLICTS = [
    ["--shard", "--index", "ivf"],
    ["--shard", "--mutate"],
    ["--coarse", "sign", "--index", "hnsw"],
    ["--rescore-mult", "8"],
    ["--coarse", "sign", "--rescore-mult", "8", "--micro-batch", "4"],
    ["--load", "{plain}", "--filter-every", "8"],
    ["--load", "{plain}", "--rescore-mult", "8"],
    ["--load", "{ivf}", "--shard"],
    ["--load", "{ivf}", "--coarse", "sign"],
]


@pytest.mark.parametrize("flags", _CONFLICTS, ids=lambda f: "_".join(f).replace("-", ""))
def test_flag_conflicts_exit_with_the_reference_message(flags, tmp_path, capsys, monkeypatch):
    plain, ivf = _no_meta_files(tmp_path)
    argv = ["--n", "64", "--dim", "16"] + [f.format(plain=plain, ivf=ivf) for f in flags]
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        rserve.main()
    assert isinstance(got.value.code, str) and got.value.code == want.value.code


def test_device_flag_has_no_fallback():
    """``--device cuda`` is the default and raises without CUDA; the
    reference's Pallas flags are not the port's."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--n", "64", "--dim", "16", "--batches", "1"])
    with pytest.raises(SystemExit):
        serve.main(["--use-kernel", "on", "--device", "cpu"])
