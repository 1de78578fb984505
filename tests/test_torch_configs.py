"""The port's config registry (``repro_torch.configs``) equals the
reference's entry by entry: ids, families, shape sets, skips, notes, and the
full and smoke configs field by field; the LM configs' parameter counts
(counted on ``meta`` tensors) equal the reference's ``jax.eval_shape``
counts.  Also the parameter carrier ``models.convert``: a reference tree's
keys, shapes and dtypes come across whole, and a mismatched tree raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as rtf
from repro_torch import configs as TC
from repro_torch.models import convert, transformer as ttf

ARCHS = sorted(RC.all_archs())
LM_ARCHS = [a for a in ARCHS if RC.get(a).family == "lm"]


def _fields(cfg) -> dict:
    """A config's fields, nested configs included, as plain values."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def test_same_arch_ids_and_cells():
    assert sorted(TC.all_archs()) == ARCHS
    for skipped in (False, True):
        assert [(a.arch_id, s.name) for a, s in TC.cells(skipped)] == \
            [(a.arch_id, s.name) for a, s in RC.cells(skipped)]


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_equals_reference(arch_id):
    r, t = RC.get(arch_id), TC.get(arch_id)
    assert (t.arch_id, t.family, t.notes, dict(t.skips)) == \
        (r.arch_id, r.family, r.notes, dict(r.skips))
    assert [(s.name, s.kind, dict(s.dims)) for s in t.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in r.shapes]
    for make in ("make_config", "make_smoke"):
        rc, tc = getattr(r, make)(), getattr(t, make)()
        assert type(tc).__name__ == type(rc).__name__
        assert _fields(tc) == _fields(rc), make


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_param_counts_equal_reference(arch_id):
    rc, tc = RC.get(arch_id).make_config(), TC.get(arch_id).make_config()
    assert tc.param_count() == rc.param_count()
    assert tc.active_param_count() == rc.active_param_count()
    assert tc.block_layout() == rc.block_layout()
    np.testing.assert_array_equal(tc.layer_windows(), rc.layer_windows())


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get("no-such-arch")


def test_convert_keeps_bf16_and_every_key():
    rcfg = dataclasses.replace(RC.get("deepseek-v3-671b").make_smoke(), dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get("deepseek-v3-671b").make_smoke(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: rtf.init_params(rcfg, k))(
        jax.random.key(1)))
    model = convert.from_reference_params(tcfg, tree, device="cpu")
    sd = model.state_dict()
    assert len(sd) == sum(
        np.prod(leaf.shape[:1]) if path[0].key == "blocks" else 1
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree))
    emb = sd["embed"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(), tree["embed"].astype(np.float32))
    layer = tree["blocks"][1]["ffn"]["w_gate"]
    np.testing.assert_array_equal(sd["blocks.1.2.ffn.w_gate"].float().numpy(),
                                  layer[2].astype(np.float32))
    assert sd["blocks.1.0.ffn.router.w"].dtype == torch.float32   # the router stays f32
    assert sum(p.numel() for p in model.parameters()) == tcfg.param_count()
    logits, _, _, _ = ttf.forward(model, tcfg, torch.zeros((1, 4), dtype=torch.int64))
    assert torch.isfinite(logits).all()


def test_convert_rejects_a_mismatched_tree():
    rcfg = RC.get("llama3.2-3b").make_smoke()
    tree = jax.tree.map(np.asarray, rtf.init_params(rcfg, jax.random.key(0)))
    other = TC.get("qwen1.5-0.5b").make_smoke()
    with pytest.raises((ValueError, RuntimeError)):
        convert.from_reference_params(other, tree, device="cpu")
    del tree["final_norm"]
    with pytest.raises(RuntimeError, match="final_norm"):
        convert.from_reference_params(TC.get("llama3.2-3b").make_smoke(), tree, device="cpu")
    with pytest.raises(TypeError):
        convert.from_reference_params(object(), tree, device="cpu")


def test_models_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get("llama3.2-3b").make_smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttf.Transformer(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttf.init_decode_cache(cfg, 1, 4)
    model = ttf.Transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.embed.device.type == "cpu"
    with pytest.raises(ValueError, match="Generator"):
        ttf.Transformer(cfg, None, device="cpu")


def test_seeded_init_is_deterministic():
    cfg = TC.get("olmoe-1b-7b").make_smoke()
    a = ttf.Transformer(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict()
    b = ttf.Transformer(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    ref = jax.eval_shape(lambda k: rtf.init_params(RC.get("olmoe-1b-7b").make_smoke(), k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert sum(v.numel() for v in a.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
