"""The port's partition rules (``repro_torch.dist.sharding``) against the
reference's ``repro.dist.sharding``, on the CPU.

Every registry arch's full config: the spec of each parameter leaf and of
each optimizer moment leaf (``['m']`` / ``['v']``), keyed by the
reference's ``keystr`` path, equals the reference's ``spec_for_path`` on
``jax.eval_shape``'s tree; the leaves' shapes and dtypes are the
reference's.  The port's trees are its modules on ``meta`` (nothing is
allocated at full width).  ``batch_sharding`` and ``corpus_sharding`` equal
the reference's on both production meshes (the reference's on a
``jax.sharding.AbstractMesh`` of the production shape).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as RC
import repro.dist.partition as rpart
import repro.dist.sharding as rshd
from repro.dist import steps as rsteps
from repro.models import gnn as rgnn
from repro.models import transformer as rtf
from repro.train.optimizer import AdamWConfig as RAdamW, init_opt_state as r_init_opt
from repro_torch import configs as TC
from repro_torch.dist import partition as tpart, sharding as tshd
from repro_torch.dist.steps import _RS_INIT, _opt_tree
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import gnn as tgnn, transformer as ttf
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

ARCHS = [a for a, arch in RC.all_archs().items() if arch.family != "retrieval"]
REF_MESH = {False: AbstractMesh((16, 16), ("data", "model")),
            True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _rules(family):
    return {"lm": "LM_RULES", "gnn": "GNN_RULES", "recsys": "RECSYS_RULES"}[family]


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch_id):
    """{keystr: (shape, dtype, spec)} of the reference's params and opt state."""
    arch = RC.get(arch_id)
    cfg = arch.make_config()
    init = {"lm": rtf.init_params, "gnn": rgnn.init_params}.get(
        arch.family, rsteps._RS_INIT.get(arch_id))
    params = jax.eval_shape(lambda k: init(cfg, k), jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    opt = jax.eval_shape(lambda p: r_init_opt(p, RAdamW()), params)
    rules = getattr(rshd, _rules(arch.family))
    out = {}
    for name, tree in (("params", params), ("opt", opt)):
        out[name] = {jax.tree_util.keystr(path): (tuple(leaf.shape), _dtype_name(leaf.dtype),
                                                   tuple(rshd.spec_for_path(
                                                       jax.tree_util.keystr(path),
                                                       len(leaf.shape), rules)))
                     for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return out


def _port_model(arch_id):
    arch = TC.get(arch_id)
    cfg = arch.make_config()
    if arch.family in ("lm", "gnn"):
        return {"lm": ttf.Transformer, "gnn": tgnn.GIN}[arch.family](cfg, device="meta")
    return _RS_INIT[arch_id](cfg, None, "meta")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_and_moment_specs_equal_reference(arch_id):
    model = _port_model(arch_id)
    rules = getattr(tshd, _rules(TC.get(arch_id).family))
    opt = _opt_tree(init_opt_state(model, AdamWConfig()))
    want = _ref_leaves(arch_id)
    for name, tree in (("params", model), ("opt", opt)):
        structs = tshd.with_shardings(tree, tshd.tree_shardings(tree, rules))
        got = {path: (s.shape, _dtype_name(s.dtype), s.spec)
               for path, s in tshd.key_paths(structs)}
        assert got == want[name], (name, sorted(set(got) ^ set(want[name]))[:5])
    sharded = [p for p, (_, _, spec) in want["params"].items() if any(spec)]
    assert bool(sharded) == (TC.get(arch_id).family != "gnn")


@pytest.mark.parametrize("multi", [False, True])
def test_batch_and_corpus_sharding_equal_reference(multi):
    mesh, ref_mesh = make_production_mesh(multi_pod=multi), REF_MESH[multi]
    axes = ("pod", "data") if multi else ("data",)
    for ndim in (1, 2, 3):
        assert tshd.batch_sharding(ndim, axes) == tuple(
            rshd.batch_sharding(ref_mesh, ndim, axes).spec)
        assert tpart.corpus_sharding(mesh, ndim) == tuple(
            rpart.corpus_sharding(ref_mesh, ndim).spec)
    assert tpart.data_axis_size(mesh) == (32 if multi else 16)


@pytest.mark.parametrize("rules", ["LM_RULES", "RECSYS_RULES", "GNN_RULES"])
def test_spec_for_path_trims_and_right_aligns(rules):
    """Paths no registry tree has (a bias under a matrix rule, a 0-d leaf, a
    stacked prefix) trim and align as the reference's."""
    paths = ["['lm_head']['b']", "['blocks'][0]['ffn']['w_gate']", "['embed']",
             "['m']['blocks'][1]['attn']['o']['w']", "['tables'][3]", "['v'][0]",
             "['item_emb']", "['mtp']['proj']['w']", "['step']", "['layers'][0]['eps']"]
    for path in paths:
        for ndim in range(4):
            assert tshd.spec_for_path(path, ndim, getattr(tshd, rules)) == tuple(
                rshd.spec_for_path(path, ndim, getattr(rshd, rules))), (path, ndim)


def test_shard_shape_rounds_up():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert tshd.shard_shape((100, 7), ("model", None), single) == (7, 7)
    assert tshd.shard_shape((100, 7), (("pod", "data"), "model"), multi) == (4, 1)
    assert tshd.shard_shape((3, 5, 9), (), single) == (3, 5, 9)
    s = tshd.ShardedStruct((33, 4), torch.bfloat16, ("data", None))
    assert tshd.bytes_per_device({"a": [s, s]}, single) == 2 * 3 * 4 * 2
