"""The port's LM training path (``transformer.lm_loss``, gradients through
the serving forwards, ``train.optimizer.make_train_step``) against the
reference's ``jax.value_and_grad`` and train step, on the CPU, at every LM
arch's smoke config (f32).

One reference parameter tree per arch (``init_params(cfg, key(0))``) is
carried across by ``from_reference_params``; gradients come back leaf by
leaf through ``convert.reference_tree`` in the reference's layout.
Tolerances: the loss within rtol 1e-5 (the MLA arch 1e-4, as its forward);
each gradient leaf within atol GRAD_ATOL + rtol GRAD_RTOL of the reference's
(XLA's and PyTorch's summation orders differ, and a backward chains more
products than a forward).  After one AdamW step (lr 1e-3) a gradient
element near zero may take the other sign and move its parameter by up to
2 lr: every parameter is held within PARAM_ATOL = 2.5 lr, and the elements
beyond 1e-6 are counted and held to under 1%.
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
from repro.models import transformer as rtf
from repro.train import optimizer as ropt
from repro_torch import configs as TC
from repro_torch.data import synthetic as tsyn
from repro_torch.models import convert, transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _leaf_paths

LM_ARCHS = ["gemma2-2b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "olmoe-1b-7b"]
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
LR = 1e-3
PARAM_ATOL = 2.5 * LR


def _loss_tol(cfg):
    return 1e-4 if cfg.mla else 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch_id: str):
    """(reference cfg, reference params, port cfg, port model, tokens [2, 16])."""
    rcfg, tcfg = RC.get(arch_id).make_smoke(), TC.get(arch_id).make_smoke()
    params = jax.jit(lambda k: rtf.init_params(rcfg, k))(jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = tsyn.lm_batch(0, 0, 2, 16, tcfg.vocab)["tokens"]
    return rcfg, params, tcfg, model, toks


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch_id: str):
    rcfg = _setup(arch_id)[0]
    return jax.jit(jax.value_and_grad(lambda p, t: rtf.lm_loss(p, rcfg, t)))


def _port_value_and_grad(model, cfg, toks):
    model = copy.deepcopy(model).requires_grad_(True)
    loss = ttf.lm_loss(model, cfg, torch.tensor(toks))
    loss.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return loss.detach(), grads


def _leaves(tree):
    return {path: np.asarray(leaf) for path, leaf in _leaf_paths(tree)}


def _assert_trees_close(got_tree, want_tree, atol, rtol, what):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), atol=atol, rtol=rtol,
                                   err_msg=f"{what} {'/'.join(path)}")


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_loss_and_grads_match_reference(arch_id):
    rcfg, params, tcfg, model, toks = _setup(arch_id)
    r_loss, r_grads = _ref_value_and_grad(arch_id)(params, jnp.asarray(toks))
    t_loss, t_grads = _port_value_and_grad(model, tcfg, toks)
    tol = _loss_tol(tcfg)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=tol, atol=tol)
    _assert_trees_close(convert.reference_tree(t_grads), r_grads, GRAD_ATOL, GRAD_RTOL,
                        "grad")


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_chunked_loss_matches_whole(arch_id):
    """loss_chunk 4 over 15 targets (three chunks, a remainder of 3; MTP's
    14: two and a remainder of 2) against the unchunked loss and gradients."""
    _, _, tcfg, model, toks = _setup(arch_id)
    whole, g_whole = _port_value_and_grad(model, tcfg, toks)
    chunked, g_chunk = _port_value_and_grad(model, dataclasses.replace(tcfg, loss_chunk=4),
                                            toks)
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6, atol=1e-6)
    for k in g_whole:
        np.testing.assert_allclose(g_chunk[k].numpy(), g_whole[k].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_remat_changes_no_byte(arch_id):
    """remat off, "full" and "dots": the same loss and gradient bytes (a
    recomputed layer gives its first pass's bytes)."""
    _, _, tcfg, model, toks = _setup(arch_id)
    runs = [_port_value_and_grad(model, dataclasses.replace(tcfg, remat=remat,
                                                            remat_policy=policy), toks)
            for remat, policy in ((False, "full"), (True, "full"), (True, "dots"))]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for k, g in grads.items():
            assert torch.equal(g, runs[0][1][k]), k


def test_dots_policy_saves_plain_matmuls_only():
    """The "dots" policy keeps mm / addmm outputs and recomputes bmm."""
    from torch.utils.checkpoint import CheckpointPolicy
    assert ttf._dots_policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert ttf._dots_policy(None, torch.ops.aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    assert (ttf._dots_policy(None, torch.ops.aten.bmm.default)
            == CheckpointPolicy.PREFER_RECOMPUTE)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_train_step_matches_reference(arch_id):
    """One ``make_train_step`` step against the reference's train step (its
    ``value_and_grad``, then its ``adamw_update``: ``make_train_step``'s body,
    with the gradient's compile shared with the test above)."""
    rcfg, params, tcfg, model, toks = _setup(arch_id)
    ocfg = ropt.AdamWConfig(lr=LR)
    r_loss, r_grads = _ref_value_and_grad(arch_id)(params, jnp.asarray(toks))
    r_params, r_state, r_gnorm = jax.jit(functools.partial(ropt.adamw_update, cfg=ocfg))(
        r_grads, ropt.init_opt_state(params, ocfg), params)
    r_m = {"loss": r_loss, "grad_norm": r_gnorm}
    model = copy.deepcopy(model)
    tcfg_opt = topt.AdamWConfig(lr=LR)
    state = topt.init_opt_state(model, tcfg_opt)
    step = topt.make_train_step(lambda m, b: ttf.lm_loss(m, tcfg, b), tcfg_opt)
    model, state, m = step(model, state, torch.tensor(toks))
    tol = _loss_tol(tcfg)
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-4)
    assert int(state["step"]) == int(r_state["step"]) == 1
    got = _leaves(convert.to_reference_params(model))
    want = _leaves(r_params)
    assert sorted(got) == sorted(want)
    n_far = n_all = 0
    for path in want:
        diff = np.abs(got[path].astype(np.float64) - np.asarray(want[path], np.float64))
        assert diff.max(initial=0) <= PARAM_ATOL, (path, diff.max())
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= n_all // 100, (n_far, n_all)
    _assert_trees_close(convert.reference_tree(state["m"]), r_state["m"], 1e-5, 1e-3, "m")
    _assert_trees_close(convert.reference_tree(state["v"]), r_state["v"], 1e-8, 1e-3, "v")


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_train_step_reduces_loss(arch_id):
    """The reference's check, on the port: 8 steps at lr 2e-3 lower the loss."""
    _, _, tcfg, model, toks = _setup(arch_id)
    ocfg = topt.AdamWConfig(lr=2e-3)
    model = copy.deepcopy(model)
    state = topt.init_opt_state(model, ocfg)
    step = topt.make_train_step(lambda m, b: ttf.lm_loss(m, tcfg, b), ocfg)
    losses = []
    for _ in range(8):
        model, state, m = step(model, state, torch.tensor(toks))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


def test_serving_builds_no_graph():
    """Parameters are created without gradients, and prefill / decode run
    under no_grad even on a model that trains."""
    _, _, tcfg, model, toks = _setup("qwen1.5-0.5b")
    assert not any(p.requires_grad for p in model.parameters())
    logits, _, _, _ = ttf.forward(model, tcfg, torch.tensor(toks))
    assert logits.grad_fn is None
    trained = copy.deepcopy(model).requires_grad_(True)
    last, caches = ttf.prefill(trained, tcfg, torch.tensor(toks), last_only=True)
    assert last.grad_fn is None and all(t.grad_fn is None for c in caches for t in c.values())
    cache = ttf.init_decode_cache(tcfg, 2, 16, device="cpu")
    lg, _ = ttf.decode_step(trained, tcfg, cache, torch.tensor(toks[:, :1]), 0)
    assert lg.grad_fn is None
