"""The port's dry-run (``repro_torch.dist.steps.build_cell``,
``repro_torch.launch.dryrun``) against the reference's cells, on the CPU.

Every registered cell (the 36 assigned and the 4 ``monavec-scan`` cells):
``model_flops`` and the step's name equal the reference's ``build_cell``
on the single-pod mesh (its analytic terms read the config and the shape,
never the mesh, so the cells built for the spec checks serve); on both
production meshes (the reference's on a ``jax.sharding.AbstractMesh`` of
their shape) every argument leaf's path, shape, dtype and spec equals the
reference's, and the bytes a device holds equal this file's own sum over
the reference's specs.  The port's cells hold meta tensors, so all of this
builds at full width without allocating; no full-width step runs here (a
full-width deepseek-v3 train step takes ~55 s to count on meta).

The meta route of the kernels' dispatch (B1's and B2's, and the other scan
wrappers through ``ops._on_card``) gives shapes only; a CPU tensor still
takes the plain path and a CUDA one its kernel.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.dist import steps as rsteps
from repro_torch import configs as TC
from repro_torch.core import rhdh
from repro_torch.dist import steps as tsteps
from repro_torch.dist.sharding import key_paths
from repro_torch.kernels import hadamard, nibble_dot, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as ttf

CELLS = [(a.arch_id, s.name) for a, s in RC.cells()]
MESHES = ["single", "multi"]
REF_MESH = {"single": AbstractMesh((16, 16), ("data", "model")),
            "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _shape(arch_id, shape_name, package):
    arch = package.get(arch_id)
    return arch, next(s for s in arch.shapes if s.name == shape_name)


@functools.lru_cache(maxsize=None)
def _ref_cells(mesh_kind):
    return {(a.arch_id, s.name): rsteps.build_cell(a, s, REF_MESH[mesh_kind])
            for a, s in RC.cells()}


@functools.lru_cache(maxsize=None)
def _port_cells(mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    return {(a.arch_id, s.name): tsteps.build_cell(a, s, mesh) for a, s in TC.cells()}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _ref_leaves(arg):
    """{keystr: (shape, dtype, spec)} of one reference argument."""
    return {jax.tree_util.keystr(p): (tuple(l.shape), _dtype_name(l.dtype),
                                      tuple(l.sharding.spec) if l.sharding is not None else ())
            for p, l in jax.tree_util.tree_flatten_with_path(arg)[0]}


def _port_leaves(structs):
    return {p: (s.shape, _dtype_name(s.dtype), s.spec) for p, s in key_paths(structs)}


def test_every_registered_cell_is_compared():
    assert len(CELLS) == 40
    assert sum(RC.get(a).family != "retrieval" for a, _ in CELLS) == 36
    assert sorted(_port_cells("single")) == sorted(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_model_flops_and_params_equal_reference(cell):
    want, got = _ref_cells("single")[cell], _port_cells("single")[cell]
    assert got.step_name == want.step_name
    assert got.model_flops == pytest.approx(want.model_flops, rel=1e-12, abs=0)
    if "params" in got.roles:
        i = got.roles.index("params")
        ref_params = {p: v[:2] for p, v in _ref_leaves(want.args[i]).items()}
        assert {p: v[:2] for p, v in _port_leaves(got.structs[i]).items()} == ref_params


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_specs_and_bytes_per_device_equal_reference(cell, mesh_kind):
    """Every argument leaf (parameters, optimizer state, batch, cache): path,
    shape, dtype and spec; decode's ``cur_len`` is a Python int here.  The
    bytes a device holds, by role, against this test's own sum over the
    reference's specs (each dim over its axes' sizes, rounded up)."""
    want, got = _ref_cells(mesh_kind)[cell], _port_cells(mesh_kind)[cell]
    mesh = REF_MESH[mesh_kind]
    assert len(got.args) == len(got.structs) == len(got.roles) == len(want.args)
    expect = {"params": 0, "opt": 0, "batch": 0, "cache": 0}
    for role, arg, structs, ref_arg in zip(got.roles, got.args, got.structs, want.args):
        leaves = _ref_leaves(ref_arg)
        if structs is None:
            assert role == "scalar" and isinstance(arg, int) and leaves == {"": ((), "int32", ())}
            continue
        assert _port_leaves(structs) == leaves, role
        for shape, dtype, spec in leaves.values():
            block = [-(-dim // math.prod(mesh.shape[a] for a in
                                         ((e,) if isinstance(e, str) else e or ())))
                     for dim, e in zip(shape, spec + (None,) * len(shape))]
            expect[role] += math.prod(block) * (2 if dtype == "bfloat16"
                                                 else np.dtype(dtype).itemsize)
    expect["total"] = sum(expect.values())
    assert dryrun.cell_bytes(got, make_production_mesh(multi_pod=mesh_kind == "multi")) == expect


def test_cells_hold_meta_tensors():
    for cell in _port_cells("single").values():
        for arg in cell.args:
            tensors = (list(arg.parameters()) if isinstance(arg, torch.nn.Module)
                       else [t for _, t in key_paths(arg) if isinstance(t, torch.Tensor)])
            assert all(t.device.type == "meta" for t in tensors)


def test_variants():
    arch, shape = _shape("llama3.2-3b", "prefill_32k", TC)
    mesh = make_production_mesh()
    full = arch.make_config().n_layers
    assert sum(len(b) for b in tsteps.build_cell(arch, shape, mesh, "scan").args[0].blocks) == full
    probe = tsteps.build_cell(arch, shape, mesh, "probe3")
    assert probe.step_name == "lm_prefill[probe3]"
    assert sum(len(b) for b in probe.args[0].blocks) == 3
    arch, shape = _shape("deepseek-v3-671b", "decode_32k", TC)
    probe = tsteps.build_cell(arch, shape, mesh, "probe2")       # first_dense_layers -> 1
    assert [len(b) for b in probe.args[0].blocks] == [1, 1]
    for bad in ("bogus", "probe", "scan2"):
        with pytest.raises(ValueError, match="unknown LM variant"):
            tsteps.build_cell(arch, shape, mesh, bad)


def test_smoke_prefill_counted_flops():
    """``counted_flops`` of a prefill against ``_lm_flops``: with
    ``last_only=True`` the (tied) head runs at the last position alone, and
    the norms' parameters, in the analytic 2 x params x tokens term, are no
    matmul; the rest (every projection, the full [S, S] score and value
    products of the analytic attention term) is counted exactly."""
    arch = dataclasses.replace(TC.get("llama3.2-3b"), make_config=TC.get("llama3.2-3b").make_smoke)
    b, s = 2, 64
    shape = TC.ShapeSpec("p", "prefill", {"seq_len": s, "global_batch": b})
    cell = tsteps.build_cell(arch, shape, make_production_mesh())
    cfg = arch.make_config()
    counted = dryrun.count_flops(cell)
    norms = sum(p.numel() for n, p in cell.args[0].named_parameters()
                if n.endswith(("ln", "norm")))
    assert cfg.tie_embeddings and not cfg.moe
    expect = cell.model_flops - 2 * cfg.vocab * cfg.d_model * b * (s - 1) - 2 * norms * b * s
    assert counted == expect
    assert cell.model_flops == tsteps._lm_flops(cfg, b, s, mode="prefill")
    logits, caches = cell.fn(*cell.args)
    assert logits.shape == (b, cfg.vocab) and logits.device.type == "meta"


def test_run_cell_writes_the_record(tmp_path):
    rec = dryrun.run_cell("fm", "serve_p99", "multi", "baseline", tmp_path)
    on_disk = json.loads((tmp_path / "fm__serve_p99__multi__baseline.json").read_text())
    assert on_disk == rec and rec["ok"]
    for key in ("arch", "shape", "mesh", "variant", "ok", "n_devices", "step", "model_flops",
                "counted_flops", "counted_flops_by", "bytes_per_device", "total_s"):
        assert key in rec, key
    assert rec["n_devices"] == 512 and rec["step"] == "fm_serve"
    assert set(rec["bytes_per_device"]) == {"params", "opt", "batch", "cache", "total"}
    rec = dryrun.run_cell("two-tower-retrieval", "retrieval_cand", "single", "baseline",
                          tmp_path)
    assert rec["ok"] and "B1" in rec["counted_flops_by"] and "B2" in rec["counted_flops_by"]
    rec = dryrun.run_cell("gemma2-2b", "decode_32k", "single", "nope", tmp_path)
    assert not rec["ok"] and "unknown LM variant" in rec["error"] and rec["traceback"]


def test_main_exit_codes(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--mesh", "both",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "gin-tu__molecule__multi__baseline.json", "gin-tu__molecule__single__baseline.json"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--variant", "x",
                     "--out", str(tmp_path)])
    assert e.value.code == 0         # not an LM: the variant is not read, as the reference's
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--out", str(tmp_path)])
    assert e.value.code not in (0, None)


def test_import_changes_no_environment_variable():
    code = ("import os; before = dict(os.environ); import repro_torch.launch.dryrun; "
            "assert dict(os.environ) == before; print('ok')")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# The kernels' meta route.
# ---------------------------------------------------------------------------

def test_meta_tensors_take_the_shape_only_route():
    n, d, b = 1 << 20, 1024, 3
    launches = (nibble_dot.nibble_dot_cuda.launches, hadamard.fwht_cuda.launches)
    for bits, width in ((4, d // 2), (2, d // 4)):
        out = ops.score_raw(torch.empty((n, width), dtype=torch.uint8, device="meta"),
                            torch.empty((b, d), device="meta"), bits=bits)
        assert out.device.type == "meta" and out.shape == (b, n) and out.dtype == torch.float32
    x = torch.empty((5, 1000), device="meta")
    y = hadamard.signed_fwht(x, rhdh.rademacher_signs(7, 1024, "meta"), 1024)
    assert y.device.type == "meta" and y.shape == (5, 1024) and y.dtype == torch.float32
    assert rhdh.rhdh_apply(x, 7).shape == (5, 1024)
    assert (nibble_dot.nibble_dot_cuda.launches, hadamard.fwht_cuda.launches) == launches


def test_cpu_keeps_the_plain_path_and_other_devices_raise():
    rng = np.random.RandomState(0)
    packed = torch.from_numpy(rng.randint(0, 256, (70, 32)).astype(np.uint8))
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    launches = (nibble_dot.nibble_dot_cuda.launches, hadamard.fwht_cuda.launches)
    assert torch.equal(ops.score_raw(packed, q, bits=4), ref.nibble_dot_ref(packed, q))
    x = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    signs = rhdh.rademacher_signs(3, 64)
    assert torch.equal(hadamard.signed_fwht(x, signs, 64),
                       hadamard.signed_fwht_plain(x, signs, 64))
    assert (nibble_dot.nibble_dot_cuda.launches, hadamard.fwht_cuda.launches) == launches
    other = types.SimpleNamespace(is_cuda=False, device=torch.device("mps"))
    with pytest.raises(ValueError, match="no kernel path"):
        ops._on_card(other)
    with pytest.raises(ValueError, match="no Hadamard path"):
        hadamard.signed_fwht(other, signs, 64)


def test_decode_cell_runs_on_meta():
    """A decode step on meta writes its cache in place and gives [B, V]
    logits (``cur_len`` a Python int, as ``decode_step`` takes it)."""
    arch = dataclasses.replace(TC.get("gemma2-2b"), make_config=TC.get("gemma2-2b").make_smoke)
    shape = TC.ShapeSpec("d", "decode", {"seq_len": 32, "global_batch": 4})
    cell = tsteps.build_cell(arch, shape, make_production_mesh())
    assert cell.roles == ("params", "cache", "batch", "scalar") and cell.args[3] == 31
    logits, cache = cell.fn(*cell.args)
    assert logits.shape == (4, arch.make_config().vocab) and cache is cell.args[1]
    assert isinstance(cell.args[0], ttf.Transformer)
