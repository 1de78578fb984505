"""The port's recsys and GNN serving forwards against the reference's on the
CPU, at smoke configs (f32), with the four synthetic generators byte-equal
and the two-tower packed retrieval (``dist.steps.two_tower_retrieve``)
against the reference's packed scan.

One reference parameter tree per arch (``*_init(cfg, key(0))``, leaves
through ``np.asarray``) goes through ``from_reference_params``.  Tolerance:
rtol 1e-5 / atol 1e-5 for every forward (DIEN's two recurrences of 12
steps: 1e-5 too).  The retrieval's codes equal the reference's exactly (the
smoke's d' = 16 rotation sums 16 terms in the same order in both), and its
top-10 ids equal the reference's but where two scores tie within the scan's
bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core import quantize as rqz
from repro.core.scoring import topk as rtopk
from repro.data import synthetic as rsyn
from repro.dist.steps import _RS_INIT, _rs_forward
from repro.kernels import ops as rops
from repro.models import gnn as rgnn
from repro.models import recsys as rrs
from repro_torch import configs as TC
from repro_torch.core import quantize as tqz
from repro_torch.data import synthetic as tsyn
from repro_torch.dist import steps as tsteps
from repro_torch.models import convert, gnn as tgnn, recsys as trs

RS_ARCHS = ["dlrm-rm2", "dien", "fm", "two-tower-retrieval"]
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _rs_setup(arch_id: str):
    rcfg, tcfg = RC.get(arch_id).make_smoke(), TC.get(arch_id).make_smoke()
    params = jax.jit(lambda k: _RS_INIT[arch_id](rcfg, k))(jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return rcfg, params, tcfg, model


@pytest.mark.parametrize("arch_id", RS_ARCHS)
def test_rs_forward_matches_reference(arch_id):
    rcfg, params, tcfg, model = _rs_setup(arch_id)
    batch = tsyn.recsys_batch(0, 0, arch_id, tcfg, 16)
    want = _rs_forward(arch_id, params, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tsteps.rs_forward(arch_id, model, tcfg, {k: torch.tensor(v) for k, v in batch.items()})
    assert tuple(got.shape) == want.shape == (16,)
    _close(got, want)


@pytest.mark.parametrize("unroll", [False, True], ids=["scan", "unroll"])
def test_dien_scan_and_unroll(unroll):
    rcfg, params, tcfg, model = _rs_setup("dien")
    batch = tsyn.recsys_batch(0, 1, "dien", tcfg, 8)
    want = rrs.dien_forward(params, rcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                            unroll=unroll)
    got = trs.dien_forward(model, tcfg, {k: torch.tensor(v) for k, v in batch.items()},
                           unroll=unroll)
    _close(got, want)


def test_two_tower_towers():
    rcfg, params, tcfg, model = _rs_setup("two-tower-retrieval")
    batch = tsyn.recsys_batch(0, 2, "two-tower-retrieval", tcfg, 32)
    _close(trs.user_embedding(model, tcfg, torch.tensor(batch["user_hist"])),
           rrs.user_embedding(params, rcfg, jnp.asarray(batch["user_hist"])))
    items = np.arange(400, dtype=np.int32)
    cand_t = trs.item_embedding(model, tcfg, torch.tensor(items))
    cand_r = rrs.item_embedding(params, rcfg, jnp.asarray(items))
    _close(cand_t, cand_r)
    u = np.asarray(rrs.user_embedding(params, rcfg, jnp.asarray(batch["user_hist"])))
    _close(trs.score_candidates_f32(torch.tensor(u), cand_t),
           rrs.score_candidates_f32(jnp.asarray(u), cand_r))


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag(combiner, weighted):
    rng = np.random.RandomState(5)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.randint(0, 50, 40).astype(np.int32)
    bags = np.sort(rng.randint(0, 9, 40)).astype(np.int32)
    bags[bags == 4] = 5                     # bag 4 is empty
    rng.shuffle(bags)                        # lookups of a bag need not be adjacent
    w = rng.random_sample(40).astype(np.float32) if weighted else None
    want = rrs.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), 10,
                             combiner=combiner,
                             weights=None if w is None else jnp.asarray(w))
    got = trs.embedding_bag(torch.tensor(table), torch.tensor(idx), torch.tensor(bags), 10,
                            combiner=combiner, weights=None if w is None else torch.tensor(w))
    _close(got, want)


def test_two_tower_retrieve_matches_reference_packed_scan():
    rcfg, params, tcfg, model = _rs_setup("two-tower-retrieval")
    items = np.arange(tcfg.item_vocab, dtype=np.int32)
    cand = np.asarray(rrs.item_embedding(params, rcfg, jnp.asarray(items)))
    enc_r = rqz.encode(jnp.asarray(cand), metric="cosine")
    enc_t = tqz.encode(torch.tensor(cand), metric="cosine")
    np.testing.assert_array_equal(enc_t.packed.numpy(), np.asarray(enc_r.packed))
    _close(enc_t.qnorms, enc_r.qnorms, 1e-6)
    hist = tsyn.recsys_batch(0, 3, "two-tower-retrieval", tcfg, 8)["user_hist"]
    u = rrs.user_embedding(params, rcfg, jnp.asarray(hist))
    scores = rops.score_packed(rqz.encode_query(u, enc_r), enc_r, use_kernel=True,
                               interpret=True)
    r_vals, r_ids = rtopk(scores, 10)
    t_vals, t_ids = tsteps.two_tower_retrieve(model, tcfg, torch.tensor(hist), enc_t.packed,
                                              enc_t.qnorms, k=10)
    scores = np.asarray(scores)
    r_vals, r_ids = np.asarray(r_vals), np.asarray(r_ids)
    _close(t_vals, r_vals)
    for b in range(r_ids.shape[0]):
        for j in range(10):
            if t_ids[b, j] != r_ids[b, j]:     # a swap only between tied scores
                assert abs(scores[b, int(t_ids[b, j])] - r_vals[b, j]) <= 2 * TOL, (b, j)


@functools.lru_cache(maxsize=None)
def _gin_setup(readout: str = "node", n_layers: int = 0):
    import dataclasses
    rcfg, tcfg = RC.get("gin-tu").make_smoke(), TC.get("gin-tu").make_smoke()
    kw = {"readout": readout}
    if n_layers:
        kw["n_layers"] = n_layers
    rcfg, tcfg = dataclasses.replace(rcfg, **kw), dataclasses.replace(tcfg, **kw)
    params = rgnn.init_params(rcfg, jax.random.key(0))
    model = convert.from_reference_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return rcfg, params, tcfg, model


def test_gin_full_graph():
    rcfg, params, tcfg, model = _gin_setup()
    g = tsyn.random_graph(0, 200, 800, tcfg.d_feat, tcfg.n_classes)
    want = rgnn.forward_full(params, rcfg, *(jnp.asarray(g[k]) for k in ("x", "src", "dst")))
    got = tgnn.forward_full(model, tcfg, *(torch.tensor(g[k]) for k in ("x", "src", "dst")))
    assert tuple(got.shape) == (200, tcfg.n_classes)
    _close(got, want)


def test_gin_graph_readout():
    rcfg, params, tcfg, model = _gin_setup("graph")
    g = tsyn.random_graph(3, 30 * 8, 64 * 8, tcfg.d_feat, tcfg.n_classes)
    src, dst = g["src"] % 240, g["dst"] % 240
    gid = np.repeat(np.arange(8), 30)
    want = rgnn.forward_full(params, rcfg, jnp.asarray(g["x"]), jnp.asarray(src),
                             jnp.asarray(dst), graph_ids=jnp.asarray(gid), n_graphs=8)
    got = tgnn.forward_full(model, tcfg, torch.tensor(g["x"]), torch.tensor(src),
                            torch.tensor(dst), graph_ids=torch.tensor(gid), n_graphs=8)
    assert tuple(got.shape) == (8, tcfg.n_classes)
    _close(got, want)


def _csr(g, n):
    order = np.argsort(g["src"], kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(g["src"], minlength=n))])
    return indptr, g["dst"][order]


def test_gin_sampled():
    rcfg, params, tcfg, model = _gin_setup(n_layers=2)
    g = tsyn.random_graph(2, 500, 4000, tcfg.d_feat, tcfg.n_classes)
    indptr, indices = _csr(g, 500)
    frontier, blocks = tsyn.neighbor_sample(0, 0, indptr, indices, np.arange(32), (5, 3))
    want = rgnn.forward_sampled(params, rcfg, jnp.asarray(g["x"][frontier]),
                                [(jnp.asarray(s), jnp.asarray(d), n) for s, d, n in blocks])
    got = tgnn.forward_sampled(model, tcfg, torch.tensor(g["x"][frontier]),
                               [(torch.tensor(s), torch.tensor(d), n) for s, d, n in blocks])
    assert tuple(got.shape) == (32, tcfg.n_classes)
    _close(got, want)


# ---------------------------------------------------------------------------
# The synthetic generators: byte-equal to the reference's.
# ---------------------------------------------------------------------------

def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("args", [(0, 0, 2, 16, 512), (1, 5, 3, 100, 151936)])
def test_lm_batch_bytes(args):
    _same(tsyn.lm_batch(*args), rsyn.lm_batch(*args))


@pytest.mark.parametrize("args", [(0, 200, 800, 8, 3), (4, 97, 300, 5, 1)])
def test_random_graph_bytes(args):
    _same(tsyn.random_graph(*args), rsyn.random_graph(*args))


def test_neighbor_sample_bytes():
    g = rsyn.random_graph(2, 500, 4000, 8, 3)
    indptr, indices = _csr(g, 500)
    for step, fanouts in [(0, (5, 3)), (3, (15, 10))]:
        _same(tsyn.neighbor_sample(1, step, indptr, indices, np.arange(17), fanouts),
              rsyn.neighbor_sample(1, step, indptr, indices, np.arange(17), fanouts))


@pytest.mark.parametrize("arch_id", RS_ARCHS)
def test_recsys_batch_bytes(arch_id):
    for cfg_of in ("make_smoke", "make_config"):
        cfg = getattr(TC.get(arch_id), cfg_of)()
        _same(tsyn.recsys_batch(2, 3, arch_id, cfg, 64),
              rsyn.recsys_batch(2, 3, arch_id, getattr(RC.get(arch_id), cfg_of)(), 64))
    with pytest.raises(ValueError):
        tsyn.recsys_batch(0, 0, "gin-tu", cfg, 4)
