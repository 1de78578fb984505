"""The port's checkpoint manager and fault-tolerant loop
(``repro_torch.train.checkpoint`` / ``loop``) against the reference's on the
CPU: the same files both ways, bfloat16 leaves restored by the port (the
reference's ``restore`` refuses them: ``jnp.asarray`` of a ``|V2`` array),
keep-k, ``.tmp`` directories, and crash -> restore -> the same losses.

Files are compared byte for byte (every ``.npy`` and the manifest); values
restored across packages are compared exactly.  The port's crash-and-resume
run must reproduce the uninterrupted run's losses and parameters bit for
bit (the reference's own check holds its losses to rtol 1e-6).
"""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as rtf
from repro.train import checkpoint as rckpt
from repro.train import loop as rloop
from repro.train import optimizer as ropt
from repro_torch import configs as TC
from repro_torch.data import synthetic as tsyn
from repro_torch.models import convert, transformer as ttf
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _ref_tree(dtype):
    rng = np.random.RandomState(0)
    return {"params": {"w": jnp.asarray(rng.standard_normal((4, 3))).astype(dtype),
                       "blocks": [{"k": jnp.asarray(rng.standard_normal((2, 5))).astype(dtype)}],
                       "b": jnp.ones((3,), dtype)},
            "opt": {"step": jnp.int32(7), "m": [jnp.zeros((2,), jnp.float32)]}}


def _torch_leaf(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a))


def test_port_save_reference_restore(tmp_path):
    tree = jax.tree.map(_torch_leaf, _ref_tree(jnp.float32))
    tckpt.CheckpointManager(str(tmp_path)).save(3, tree)
    restored, manifest = rckpt.CheckpointManager(str(tmp_path)).restore(_ref_tree(jnp.float32))
    assert manifest["step"] == 3
    for (pa, a), (pb, b) in zip(rckpt._leaf_paths(restored), tckpt._leaf_paths(tree)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_save_port_restore(tmp_path, dtype):
    """The reference's files, f32 and bf16, restore on the port in their
    manifest dtype (bf16 leaves: the reference cannot restore these)."""
    ref = _ref_tree(jnp.dtype(dtype))
    rckpt.CheckpointManager(str(tmp_path)).save(5, ref)
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    if dtype == "bfloat16":
        assert {"bfloat16", "int32", "float32"} == {e["dtype"] for e in manifest["leaves"]}
        assert b"'descr': '<V2'" in (tmp_path / "step_00000005" / "params__w.npy").read_bytes()
        with pytest.raises(TypeError):
            rckpt.CheckpointManager(str(tmp_path)).restore(ref)
    for template in (None, jax.tree.map(lambda a: None, ref)):
        got, m = tckpt.CheckpointManager(str(tmp_path)).restore(template)
        assert m == manifest
        for (pa, a), (pb, b) in zip(rckpt._leaf_paths(ref), tckpt._leaf_paths(got)):
            assert pa == pb
            assert b.dtype == _torch_leaf(a).dtype
            assert torch.equal(b, _torch_leaf(a)), pa
    assert isinstance(got["params"]["blocks"], list)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_files_byte_equal(tmp_path, dtype):
    """The same tree saved by both packages: every file (manifest included)
    byte for byte, torch tensors and the reference's numpy arrays alike."""
    ref = _ref_tree(jnp.dtype(dtype))
    rckpt.CheckpointManager(str(tmp_path / "r")).save(1, ref)
    tckpt.CheckpointManager(str(tmp_path / "t")).save(1, jax.tree.map(_torch_leaf, ref))
    tckpt.CheckpointManager(str(tmp_path / "n")).save(1, jax.tree.map(np.asarray, ref))
    want = _files(tmp_path / "r" / "step_00000001")
    assert _files(tmp_path / "t" / "step_00000001") == want
    assert _files(tmp_path / "n" / "step_00000001") == want


@pytest.mark.parametrize("arch_id,dtype", [("qwen1.5-0.5b", "float32"),
                                           ("llama3.2-3b", "bfloat16")])
def test_converted_params_save_byte_equal(tmp_path, arch_id, dtype):
    """A reference init converted to the port and saved at step 0 (with
    ``to_reference_params`` and the loop's own tree) writes the reference's
    files for the same tree, byte for byte."""
    rcfg = dataclasses.replace(RC.get(arch_id).make_smoke(), dtype=dtype)
    tcfg = dataclasses.replace(TC.get(arch_id).make_smoke(), dtype=dtype)
    params = jax.jit(lambda k: rtf.init_params(rcfg, k))(jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    ocfg = ropt.AdamWConfig()
    rckpt.CheckpointManager(str(tmp_path / "r")).save(
        0, {"params": params, "opt": ropt.init_opt_state(params, ocfg)})
    tckpt.CheckpointManager(str(tmp_path / "t")).save(
        0, tloop.checkpoint_tree(model, topt.init_opt_state(model, topt.AdamWConfig())))
    tckpt.CheckpointManager(str(tmp_path / "c")).save(
        0, {"params": convert.to_reference_params(model),
            "opt": ropt.init_opt_state(params, ocfg)})
    want = _files(tmp_path / "r" / "step_00000000")
    assert _files(tmp_path / "t" / "step_00000000") == want
    assert _files(tmp_path / "c" / "step_00000000") == want
    # ... and restore into an equal model and state.
    restored, _ = tckpt.CheckpointManager(str(tmp_path / "t")).restore()
    twin = convert.from_reference_params(tcfg, restored["params"], device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_keep_k_and_tmp_never_restored(tmp_path):
    ckpt = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.full((3,), float(s))})
    assert ckpt.all_steps() == [3, 4]
    os.makedirs(tmp_path / "step_00000009.tmp")            # a crashed write
    (tmp_path / "step_00000008").mkdir()                    # no manifest: incomplete
    assert ckpt.latest_step() == 4
    got, manifest = ckpt.restore()
    assert manifest["step"] == 4 and torch.equal(got["x"], torch.full((3,), 4.0))
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_to_device_and_step(tmp_path):
    ckpt = tckpt.CheckpointManager(str(tmp_path))
    ckpt.save(1, {"x": torch.ones(2, dtype=torch.bfloat16)})
    ckpt.save(2, {"x": torch.zeros(2, dtype=torch.bfloat16)})
    got, manifest = ckpt.restore(step=1, device="cpu")
    assert manifest["step"] == 1 and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], torch.ones(2, dtype=torch.bfloat16))


# -- the loop: crash -> restore -> the same continuation ---------------------

QWEN = TC.get("qwen1.5-0.5b").make_smoke()


def _port_run(d, steps, fail_at=None, cfg=QWEN):
    return tloop.train(
        loss_fn=lambda m, b: ttf.lm_loss(m, cfg, b["tokens"]),
        init_params_fn=lambda: ttf.Transformer(cfg, torch.Generator().manual_seed(0), "cpu"),
        batch_fn=lambda s: {"tokens": torch.tensor(tsyn.lm_batch(0, s, 2, 16,
                                                                 cfg.vocab)["tokens"])},
        n_steps=steps, opt_cfg=topt.AdamWConfig(lr=1e-3),
        ckpt=tckpt.CheckpointManager(str(d), keep=2), ckpt_every=4, simulate_failure_at=fail_at)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crash_restore_bitwise_identical(tmp_path, dtype):
    """The reference's check on the port (qwen1.5's smoke config, 2 x 16
    tokens, keep 2, every 4 steps): crash at step 9, resume at 8 from the
    same directory; losses, parameters and moments bit for bit."""
    cfg = dataclasses.replace(QWEN, dtype=dtype)
    ref = _port_run(tmp_path / "a", 12, cfg=cfg)
    with pytest.raises(tloop.SimulatedFailure):
        _port_run(tmp_path / "b", 12, fail_at=9, cfg=cfg)
    resumed = _port_run(tmp_path / "b", 12, cfg=cfg)
    assert resumed.start_step == 8 and ref.start_step == 0
    assert resumed.losses == ref.losses[8:]
    for (k, a), (_, b) in zip(ref.params.state_dict().items(),
                              resumed.params.state_dict().items()):
        assert a.dtype == b.dtype == cfg.torch_dtype and torch.equal(a, b), k
    for part in ("m", "v"):
        for k in ref.opt_state[part]:
            assert torch.equal(ref.opt_state[part][k], resumed.opt_state[part][k]), k
    assert torch.equal(ref.opt_state["step"], resumed.opt_state["step"])
    assert len(tckpt.CheckpointManager(str(tmp_path / "a"), keep=2).all_steps()) <= 2


def test_port_resumes_reference_run(tmp_path):
    """The reference's loop writes step 8 of its 12; the port restores it
    and runs steps 8-11 to the reference's losses (rtol 1e-5)."""
    rcfg = RC.get("qwen1.5-0.5b").make_smoke()
    batch = lambda s: {"tokens": jnp.asarray(tsyn.lm_batch(0, s, 2, 16, rcfg.vocab)["tokens"])}
    ref = rloop.train(loss_fn=lambda p, b: rtf.lm_loss(p, rcfg, b["tokens"]),
                      init_params_fn=lambda: rtf.init_params(rcfg, jax.random.key(0)),
                      batch_fn=batch, n_steps=12, opt_cfg=ropt.AdamWConfig(lr=1e-3),
                      ckpt=rckpt.CheckpointManager(str(tmp_path), keep=2), ckpt_every=4)
    for s in rckpt.CheckpointManager(str(tmp_path)).all_steps():
        if s != 8:
            shutil.rmtree(tmp_path / f"step_{s:08d}")
    resumed = tloop.train(
        loss_fn=lambda m, b: ttf.lm_loss(m, QWEN, b["tokens"]),
        init_params_fn=lambda: ttf.Transformer(QWEN, torch.Generator().manual_seed(1), "cpu"),
        batch_fn=lambda s: {"tokens": torch.tensor(np.asarray(batch(s)["tokens"]))},
        n_steps=12, opt_cfg=topt.AdamWConfig(lr=1e-3),
        ckpt=tckpt.CheckpointManager(str(tmp_path), keep=2), ckpt_every=4)
    assert resumed.start_step == 8
    np.testing.assert_allclose(resumed.losses, ref.losses[8:], rtol=1e-5)


def test_train_stands_alone_without_jax_or_ml_dtypes(tmp_path):
    """The training package imports and round-trips a bf16 checkpoint with
    JAX, the reference and ``ml_dtypes`` blocked (the card's machine has no
    ``ml_dtypes``)."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from repro_torch.train import CheckpointManager\n"
        "from repro_torch.launch import train\n"
        "from repro_torch.models import convert\n"
        "ck = CheckpointManager(sys.argv[1])\n"
        "x = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)\n"
        "ck.save(1, {'p': {'w': x}})\n"
        "got, m = ck.restore()\n"
        "assert got['p']['w'].dtype == torch.bfloat16 and torch.equal(got['p']['w'], x)\n"
        "assert m['leaves'][0]['dtype'] == 'bfloat16'\n"
        "assert convert.to_numpy(x).dtype.str == '|V2'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
