"""The port's recsys and GNN losses and their gradients against the
reference's on the CPU (smoke configs, f32), the reference's own training
checks repeated on the port, and ``python -m repro_torch.launch.train``
in-process for one arch of each family.

Inputs are made as in ``test_torch_models_recsys.py``: one reference
parameter tree per arch carried across by ``from_reference_params``, the
batches from ``recsys_batch`` / ``random_graph``.  Tolerances: losses within
rtol 1e-5 / atol 1e-6; each gradient leaf within atol GRAD_ATOL + rtol
GRAD_RTOL of the reference's (tables get dense gradients on both sides, as
``jax.value_and_grad`` gives them: a row no lookup touched is exactly 0).
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.dist.steps import _RS_INIT as R_INIT, _RS_LOSS as R_LOSS
from repro.models import gnn as rgnn
from repro.models import recsys as rrs
from repro_torch import configs as TC
from repro_torch.data import synthetic as tsyn
from repro_torch.dist.steps import _RS_INIT as T_INIT, _RS_LOSS as T_LOSS
from repro_torch.launch import train as launch_train
from repro_torch.models import convert, gnn as tgnn, recsys as trs
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _leaf_paths

RS_ARCHS = ["dlrm-rm2", "dien", "fm", "two-tower-retrieval"]
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _grads_of(model, loss_fn):
    model = copy.deepcopy(model).requires_grad_(True)
    loss = loss_fn(model)
    loss.backward()
    return loss.detach(), convert.reference_tree(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in model.named_parameters()})


def _assert_grads(got, want):
    got = {p: np.asarray(a) for p, a in _leaf_paths(got)}
    want = {p: np.asarray(a) for p, a in _leaf_paths(want)}
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path].astype(np.float64), want[path].astype(np.float64),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg="/".join(path))


# -- the losses alone ---------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True], ids=["random", "zero_logits"])
def test_bce_loss_and_grad(ties):
    rng = np.random.RandomState(0)
    lg = rng.standard_normal(64).astype(np.float32) * 3
    if ties:
        lg[::4] = 0.0                         # jnp.maximum's tie: half the gradient each side
    lb = rng.randint(0, 2, 64).astype(np.int32)
    r_loss, r_g = jax.value_and_grad(rrs.bce_loss)(jnp.asarray(lg), jnp.asarray(lb))
    x = torch.tensor(lg, requires_grad=True)
    t_loss = trs.bce_loss(x, torch.tensor(lb))
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(r_loss), **LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(r_g), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "mask"])
def test_nll_loss_and_grad(masked):
    rng = np.random.RandomState(1)
    lg = rng.standard_normal((50, 7)).astype(np.float32)
    lb = rng.randint(0, 7, 50).astype(np.int32)
    mask = (rng.random_sample(50) < 0.4).astype(np.float32) if masked else None
    r_loss, r_g = jax.value_and_grad(rgnn.nll_loss)(
        jnp.asarray(lg), jnp.asarray(lb), None if mask is None else jnp.asarray(mask))
    x = torch.tensor(lg, requires_grad=True)
    t_loss = tgnn.nll_loss(x, torch.tensor(lb), None if mask is None else torch.tensor(mask))
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(r_loss), **LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(r_g), rtol=1e-6, atol=1e-8)


def test_nll_loss_empty_mask():
    """An all-zero mask divides by max(0, 1): a zero loss, as the reference."""
    lg = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    got = tgnn.nll_loss(lg, torch.zeros(5, dtype=torch.int64), torch.zeros(5))
    want = rgnn.nll_loss(jnp.asarray(lg.numpy()), jnp.zeros(5, jnp.int32), jnp.zeros(5))
    assert float(got) == float(want) == 0.0


# -- recsys losses and gradients ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _rs_setup(arch_id: str):
    rcfg, tcfg = RC.get(arch_id).make_smoke(), TC.get(arch_id).make_smoke()
    params = jax.jit(lambda k: R_INIT[arch_id](rcfg, k))(jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return rcfg, params, tcfg, model


@pytest.mark.parametrize("arch_id", RS_ARCHS)
def test_rs_loss_and_grads_match_reference(arch_id):
    rcfg, params, tcfg, model = _rs_setup(arch_id)
    batch = tsyn.recsys_batch(0, 0, arch_id, tcfg, 32)
    r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, b: R_LOSS[arch_id](p, rcfg, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_grads = _grads_of(model, lambda m: T_LOSS[arch_id](
        m, tcfg, {k: torch.tensor(v) for k, v in batch.items()}))
    np.testing.assert_allclose(float(t_loss), float(r_loss), **LOSS_TOL)
    _assert_grads(t_grads, r_grads)


@pytest.mark.parametrize("unroll", [False, True], ids=["scan", "unroll"])
def test_dien_grads_scan_and_unroll(unroll):
    rcfg, params, tcfg, model = _rs_setup("dien")
    batch = tsyn.recsys_batch(0, 1, "dien", tcfg, 16)
    r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, b: rrs.bce_loss(rrs.dien_forward(
        p, rcfg, b, unroll=unroll), b["label"])))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_grads = _grads_of(model, lambda m: trs.bce_loss(trs.dien_forward(
        m, tcfg, {k: torch.tensor(v) for k, v in batch.items()}, unroll=unroll),
        torch.tensor(batch["label"])))
    np.testing.assert_allclose(float(t_loss), float(r_loss), **LOSS_TOL)
    _assert_grads(t_grads, r_grads)


def test_tables_get_dense_gradients():
    """Every table row gets a gradient; untouched rows exactly 0 (no sparse grads)."""
    _, _, tcfg, model = _rs_setup("fm")
    batch = tsyn.recsys_batch(0, 0, "fm", tcfg, 8)
    model = copy.deepcopy(model).requires_grad_(True)
    trs.fm_loss(model, tcfg, {k: torch.tensor(v) for k, v in batch.items()}).backward()
    g = model.v[0].grad
    assert g is not None and not g.is_sparse and g.shape == model.v[0].shape
    touched = np.unique(batch["sparse"][:, 0])
    rest = np.setdiff1d(np.arange(g.shape[0]), touched)
    assert torch.count_nonzero(g[torch.tensor(rest)]) == 0
    assert torch.count_nonzero(g[torch.tensor(touched)]) > 0


# -- GIN ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gin_setup(readout: str = "node"):
    rcfg = dataclasses.replace(RC.get("gin-tu").make_smoke(), readout=readout)
    tcfg = dataclasses.replace(TC.get("gin-tu").make_smoke(), readout=readout)
    params = jax.jit(lambda k: rgnn.init_params(rcfg, k))(jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return rcfg, params, tcfg, model


def test_gin_full_graph_grads_with_mask():
    rcfg, params, tcfg, model = _gin_setup()
    g = tsyn.random_graph(0, 120, 500, tcfg.d_feat, tcfg.n_classes)
    mask = (np.arange(120) % 3 == 0).astype(np.float32)        # the training nodes
    rj = {k: jnp.asarray(v) for k, v in g.items()}
    tt = {k: torch.tensor(v) for k, v in g.items()}
    r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, b, mk: rgnn.nll_loss(
        rgnn.forward_full(p, rcfg, b["x"], b["src"], b["dst"]), b["labels"], mk)))(
        params, rj, jnp.asarray(mask))
    t_loss, t_grads = _grads_of(model, lambda m: tgnn.nll_loss(
        tgnn.forward_full(m, tcfg, tt["x"], tt["src"], tt["dst"]), tt["labels"],
        torch.tensor(mask)))
    np.testing.assert_allclose(float(t_loss), float(r_loss), **LOSS_TOL)
    _assert_grads(t_grads, r_grads)


def test_gin_sampled_and_graph_readout_grads():
    rcfg, params, tcfg, model = _gin_setup()
    g = tsyn.random_graph(2, 300, 2400, tcfg.d_feat, tcfg.n_classes)
    order = np.argsort(g["src"], kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(g["src"], minlength=300))])
    frontier, blocks = tsyn.neighbor_sample(0, 0, indptr, g["dst"][order], np.arange(16),
                                            (5, 3))
    labels = g["labels"][:16]
    sizes = [n for _, _, n in blocks]
    r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, f, bl, y: rgnn.nll_loss(
        rgnn.forward_sampled(p, rcfg, f, [(s, d, n) for (s, d), n in zip(bl, sizes)]), y)))(
        params, jnp.asarray(g["x"][frontier]),
        [(jnp.asarray(s), jnp.asarray(d)) for s, d, _ in blocks], jnp.asarray(labels))
    t_loss, t_grads = _grads_of(model, lambda m: tgnn.nll_loss(tgnn.forward_sampled(
        m, tcfg, torch.tensor(g["x"][frontier]),
        [(torch.tensor(s), torch.tensor(d), n) for s, d, n in blocks]), torch.tensor(labels)))
    np.testing.assert_allclose(float(t_loss), float(r_loss), **LOSS_TOL)
    _assert_grads(t_grads, r_grads)

    rcfg, params, tcfg, model = _gin_setup("graph")
    mol = tsyn.random_graph(3, 240, 512, tcfg.d_feat, tcfg.n_classes)
    gid = np.repeat(np.arange(8), 30)
    y = np.arange(8) % tcfg.n_classes
    r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p, x, src, dst, gi, yy: rgnn.nll_loss(
        rgnn.forward_full(p, rcfg, x, src, dst, graph_ids=gi, n_graphs=8), yy)))(
        params, jnp.asarray(mol["x"]), jnp.asarray(mol["src"]) % 240,
        jnp.asarray(mol["dst"]) % 240, jnp.asarray(gid), jnp.asarray(y))
    t_loss, t_grads = _grads_of(model, lambda m: tgnn.nll_loss(tgnn.forward_full(
        m, tcfg, torch.tensor(mol["x"]), torch.tensor(mol["src"]) % 240,
        torch.tensor(mol["dst"]) % 240, graph_ids=torch.tensor(gid), n_graphs=8),
        torch.tensor(y)))
    np.testing.assert_allclose(float(t_loss), float(r_loss), **LOSS_TOL)
    _assert_grads(t_grads, r_grads)


def test_gin_training_learns_communities():
    """The reference's check on the port: 25 steps at lr 5e-3 halve the loss."""
    cfg = TC.get("gin-tu").make_smoke()
    model = tgnn.GIN(cfg, torch.Generator().manual_seed(0), "cpu")
    g = {k: torch.tensor(v) for k, v in
         tsyn.random_graph(1, 300, 2400, cfg.d_feat, cfg.n_classes).items()}
    ocfg = topt.AdamWConfig(lr=5e-3)
    step = topt.make_train_step(lambda m, b: tgnn.nll_loss(
        tgnn.forward_full(m, cfg, b["x"], b["src"], b["dst"]), b["labels"]), ocfg)
    state = topt.init_opt_state(model, ocfg)
    losses = []
    for _ in range(25):
        model, state, m = step(model, state, g)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0]


@pytest.mark.parametrize("arch_id", RS_ARCHS)
def test_recsys_train_step(arch_id):
    """The reference's check on the port: 20 steps over 4 batches lower the loss."""
    cfg = TC.get(arch_id).make_smoke()
    model = T_INIT[arch_id](cfg, torch.Generator().manual_seed(0), "cpu")
    ocfg = topt.AdamWConfig(lr=1e-3)
    step = topt.make_train_step(lambda m, b: T_LOSS[arch_id](m, cfg, b), ocfg)
    state = topt.init_opt_state(model, ocfg)
    losses = []
    for i in range(20):
        batch = {k: torch.tensor(v) for k, v in
                 tsyn.recsys_batch(0, i % 4, arch_id, cfg, 64).items()}
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


# -- the launcher, in-process -----------------------------------------------

@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "gin-tu", "fm"])
def test_launch_train_in_process(arch_id, capsys, tmp_path):
    argv = ["--arch", arch_id, "--steps", "6", "--batch", "4", "--seq-len", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    res = launch_train.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[train] {arch_id}: steps 0->6 loss ")
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    again = launch_train.main(argv[:3] + ["8"] + argv[4:])      # resumes at 6
    assert again.start_step == 6 and len(again.losses) == 2
    if arch_id != "fm":
        assert np.mean(res.losses[-3:]) < res.losses[0]


def test_launch_train_refuses_retrieval_archs():
    with pytest.raises(SystemExit, match="use examples/retrieval scripts"):
        launch_train.main(["--arch", "monavec-scan", "--device", "cpu"])
