"""The port's sharded retrieval (``repro_torch.dist``, ``MonaVec.shard``,
``engine.search_sharded``) on the CPU against the reference.

* partition sizes, bounds and padding equal the reference's; each shard is
  a buffer of its own;
* one-shard meshes against the reference's in-process (1, 1) mesh, for
  every metric, n 512 and 509, 4-bit and mixed codes: ids equal except ties
  within the f32 rule (``torch_harness``), scores within it;
* 4- and 7-shard CPU meshes (``Mesh.repeat``) against the reference on a
  real 4-device mesh, run once in a subprocess with
  ``--xla_force_host_platform_device_count=4`` (as tests/test_dist_merge.py
  does) that writes its .mvec files and results: the full scan at n 1024
  and 1021, ``where=`` / ``where_mask=`` / both, fewer admissible rows than
  k, both cascades at ``rescore_mult`` 2 and 8, the m >= n collapse, the
  tuned knob and its boost, k > n, and the f32 variant at 515 rows.  The
  port loads the reference's files (``ShardedMonaVec.load``), so both run
  on the same codes.  A cascade keeps m survivors per shard, so its result
  depends on the shard count: it is held at 4 shards only;
* ``shard()`` rejects a mutated, an IVF and an HNSW index with the
  reference's errors; a sharded index serves through ``TenantRegistry``,
  ``Searcher.warmup`` and the ``MicroBatcher``; on the card's graph path
  (stand-in captures) a plan captures once and a new mask captures nothing;
* ``PerDimWhiten``, ``score_packed_ref`` and ``pixel_corpus`` equal the
  reference's.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.core import quantize as rqz
from repro.core import scoring as rscoring
from repro.core import standardize as rstd
from repro.data import synthetic as rsyn
from repro.dist import partition as rpart
from repro.dist.retrieval import make_scan_topk_shardmap as ref_scan_shardmap
from repro.kernels import ops as rops
from repro_torch import MonaVec, engine, obs
from repro_torch.core import scoring, standardize
from repro_torch.core.allowlist import NEG
from repro_torch.core.convert import encoded_from_arrays
from repro_torch.core.predicate import Eq
from repro_torch.core.segments import SENTINEL_ID
from repro_torch.core.tenancy import TenantRegistry
from repro_torch.data import synthetic
from repro_torch.dist import (ShardedMonaVec, make_scan_topk_f32_shardmap,
                              make_scan_topk_shardmap, pad_rows, partition_bounds, scan_topk_f32,
                              scan_topk_pjit, shard_rows, shard_sizes)
from repro_torch.dist.partition import data_axis_size
from repro_torch.engine import plan as plan_mod
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.tune.result import BoostCurve, BoostPoint, TuneResult
from tests.test_torch_engine import _FakeGraph
from tests.torch_harness import (adjusted_tolerance, assert_search_matches, dot_tolerance,
                                 port_stream, reference_full_scores, reference_stream,
                                 segmented_tolerance)

DIM = 64
NQ = 9
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


# The reference on a real 4-device mesh.  The case lists are shared with the
# port's side below (``_kwargs`` builds both packages' keywords).
_CASES = {
    "crumb": ("plain", "where", "mask", "both", "few", "rm2", "rm8", "rm8_where", "rm_full"),
    "sign": ("tuned", "rm8", "boost_mask", "boost_where", "off"),
}
#: The cases whose result does not depend on the shard count (no cascade).
_INVARIANT = {"crumb": ("plain", "where", "mask", "both", "few", "rm_full"),
              "sign": ("off",)}

_KWARGS = '''
def _kwargs(name, n, Eq):
    rows = np.arange(n)
    return {"plain": {}, "tuned": {}, "where": {"where": Eq("g", 1)},
            "mask": {"where_mask": rows % 3 == 0},
            "both": {"where": Eq("g", 1), "where_mask": rows % 3 == 0},
            "few": {"where_mask": rows % 400 == 7},
            "rm2": {"rescore_mult": 2}, "rm8": {"rescore_mult": 8},
            "rm8_where": {"rescore_mult": 8, "where": Eq("g", 2)},
            "rm_full": {"rescore_mult": 200}, "off": {"rescore_mult": 0},
            "boost_mask": {"where_mask": rows % 40 == 0},
            "boost_where": {"where": Eq("g", 1)}}[name]
'''
exec(_KWARGS)

_REF_SCRIPT = '''
import sys
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_threefry_partitionable", {partitionable})
from repro.core import Eq, MonaVec
from repro.data import synthetic as syn
from repro.dist import make_scan_topk_f32_shardmap
from repro.launch.mesh import make_local_mesh
from repro.tune import BoostCurve, BoostPoint, TuneResult
{kwargs}
out = sys.argv[1]
mesh = make_local_mesh()
assert mesh.size == 4, mesh
res = {{}}
tuned = TuneResult(recall_target=0.9, k=10, n_queries=8, seed=1, met_target=True,
                   knobs={{"rescore_mult": 2}}, ladder={{}},
                   boost=BoostCurve(points=(BoostPoint(0.05, 4, 1.0), BoostPoint(0.25, 2, 1.0))))
for n in (1024, 1021):
    x = syn.embedding_corpus(51, n, {dim})
    q = jnp.asarray(syn.queries_from_corpus(x, 52, {nq}))
    for kind, cases in {cases}.items():
        idx = MonaVec.build(jnp.asarray(x), meta={{"g": np.arange(n) % 5}}, coarse=kind)
        if kind == "sign":
            idx.tuned = tuned
        idx.save(f"{{out}}/{{kind}}_{{n}}.mvec")
        sh = idx.shard(mesh)
        for name in cases:
            s, i = sh.search(q, 10, **_kwargs(name, n, Eq))
            res[f"{{kind}}_{{n}}_{{name}}_s"], res[f"{{kind}}_{{n}}_{{name}}_i"] = s, i
x = syn.embedding_corpus(53, 13, {dim})
MonaVec.build(jnp.asarray(x)).save(f"{{out}}/tiny.mvec")
s, i = MonaVec.load(f"{{out}}/tiny.mvec").shard(mesh).search(
    jnp.asarray(syn.queries_from_corpus(x, 54, {nq})), 20)
res["tiny_s"], res["tiny_i"] = s, i
rng = np.random.RandomState(0)
cand = rng.randn(515, {dim}).astype(np.float32)
user = rng.randn(3, {dim}).astype(np.float32)
res["f32_cand"], res["f32_user"] = cand, user
for metric in ("dot", "cosine", "l2"):
    with mesh:
        s, i = make_scan_topk_f32_shardmap(mesh, metric=metric, k=5)(jnp.asarray(user),
                                                                     jnp.asarray(cand))
    res[f"f32_{{metric}}_s"], res[f"f32_{{metric}}_i"] = np.asarray(s), np.asarray(i)
np.savez(f"{{out}}/ref.npz", **res)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def four_device(tmp_path_factory):
    """The reference's files and results on a 4-device mesh: (dir, npz)."""
    out = tmp_path_factory.mktemp("four_device")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    script = _REF_SCRIPT.format(partitionable=reference_stream(), kwargs=_KWARGS, dim=DIM,
                                nq=NQ, cases=repr(_CASES))
    res = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "REFERENCE_OK" in res.stdout
    return out, dict(np.load(out / "ref.npz"))


# ---------------------------------------------------------------------------
# Partition and mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(1021, 4), (1024, 4), (45000, 7), (3, 4), (1, 1)])
def test_partition_equals_reference(n, s):
    assert shard_sizes(n, s) == rpart.shard_sizes(n, s)
    for i in range(s):
        assert partition_bounds(n, s, i) == rpart.partition_bounds(n, s, i)
    assert shard_sizes(1021, 4) == (256, 1024) and partition_bounds(1021, 4, 3) == (768, 1021)


def test_pad_rows_and_shard_buffers():
    x = torch.ones((3, 2))
    assert pad_rows(x, 3) is x
    y = pad_rows(x, 5, fill=7.0)
    assert y.shape == (5, 2) and float(y[4, 0]) == 7.0
    np.testing.assert_array_equal(y.numpy(), np.asarray(rpart.pad_rows(jnp.ones((3, 2)), 5,
                                                                       fill=7.0)))
    rows = torch.arange(21, dtype=torch.uint8).reshape(7, 3)
    shards = shard_rows((CPU,) * 4, rows, fill=9)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert torch.equal(torch.cat(shards)[:7], rows) and bool((shards[3][1:] == 9).all())
    # Buffers of their own, never row views into one tensor.
    ptrs = {s.untyped_storage().data_ptr() for s in shards}
    assert len(ptrs) == 4 and all(s._base is None for s in shards)


def test_mesh():
    mesh = make_local_mesh("cpu")
    assert mesh.size == 1 and mesh.devices == (CPU,) and mesh.shape == {"data": 1, "model": 1}
    four = Mesh.repeat("cpu", 4)
    assert four.size == 4 and four.groups == ((CPU, (0, 1, 2, 3)),)
    assert data_axis_size(four) == 4 and data_axis_size(mesh) == 1
    assert Mesh((CPU, "cpu")) == Mesh.repeat(CPU, 2)
    with pytest.raises(ValueError):
        Mesh(())


# ---------------------------------------------------------------------------
# One shard against the reference's (1, 1) mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", ["4bit", "mixed"])
@pytest.mark.parametrize("n", [512, 509])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_one_shard_scan_equals_reference(metric, n, bits):
    corpus = rsyn.embedding_corpus(11, n, 128)
    if bits == "mixed":
        enc = rqz.encode_mixed(jnp.asarray(corpus), metric=metric, seed=5, avg_bits=3.0)
    else:
        enc = rqz.encode(jnp.asarray(corpus), metric=metric, seed=5)
    q = rqz.encode_query(jnp.asarray(corpus[:3] + 0.02), enc)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        want = ref_scan_shardmap(mesh, metric=metric, k=10, bits=enc.bits,
                                 n4_dims=enc.n4_dims)(q, enc.packed, enc.qnorms)
    q_np, packed, qnorms = (np.array(a) for a in (q, enc.packed, enc.qnorms))
    got = make_scan_topk_shardmap(Mesh.repeat("cpu", 1), metric=metric, k=10, bits=enc.bits,
                                  n4_dims=enc.n4_dims)(
        torch.from_numpy(q_np), torch.from_numpy(packed), torch.from_numpy(qnorms))
    tol = adjusted_tolerance(dot_tolerance(q_np, packed, enc.bits, enc.n4_dims), qnorms, metric)
    full = np.asarray(rops.score_packed(q, enc, use_kernel=False))
    ids = np.arange(n, dtype=np.uint64)
    # The single-array reference gives the one shard's bytes.
    whole = scan_topk_pjit(torch.from_numpy(q_np), torch.from_numpy(packed),
                           torch.from_numpy(qnorms), metric=metric, k=10, bits=enc.bits,
                           n4_dims=enc.n4_dims)
    assert torch.equal(whole[0], got[0]) and torch.equal(whole[1], got[1])
    assert_search_matches((got[0].numpy(), got[1].numpy().astype(np.uint64)),
                          (np.asarray(want[0]), np.asarray(want[1]).astype(np.uint64)),
                          full, ids, tol)


def _port_over(ref: RefMonaVec) -> MonaVec:
    enc = ref.backend.enc
    return MonaVec.from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=enc.seed,
                               metric=enc.metric, bits=enc.bits, dim=enc.dim,
                               dim_pad=enc.dim_pad, n4_dims=enc.n4_dims, ids=ref.backend.ids,
                               device="cpu")


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_one_shard_index_equals_reference_and_unsharded(metric):
    """``MonaVec.shard`` over one CPU shard against the reference's
    ``ShardedMonaVec`` on its (1, 1) mesh, and against the port's unsharded
    search on the same codes (byte for byte)."""
    x = rsyn.embedding_corpus(12, 509, DIM)
    ext = (5 + 3 * np.arange(509)).astype(np.uint64)
    ref = RefMonaVec.build(jnp.asarray(x), metric=metric, ids=ext, avg_bits=3.0)
    idx = _port_over(ref)
    sh = idx.shard()
    assert sh.mesh == make_local_mesh("cpu") and sh.n == 509
    q = np.asarray(rsyn.queries_from_corpus(x, 13, NQ))
    tol = segmented_tolerance(idx, q)
    full = reference_full_scores(ref, q)
    rsh = ref.shard(jax.make_mesh((1, 1), ("data", "model")))
    for kw in ({}, {"where_mask": np.arange(509) % 4 == 1}):
        got = sh.search(q, 10, **kw)
        assert_search_matches(got, rsh.search(jnp.asarray(q), 10, **kw), full, ext, tol)
        unsharded = idx.search(q, 10, **kw)
        assert got[0].tobytes() == unsharded[0].tobytes() and np.array_equal(got[1],
                                                                              unsharded[1])


# ---------------------------------------------------------------------------
# 4 and 7 shards against the reference's 4-device mesh.
# ---------------------------------------------------------------------------

def _check(got, want, n, ref, q, idx):
    assert got[1].shape == want[1].shape and got[1].dtype == np.uint64
    real = got[1][got[1] != SENTINEL_ID]
    assert (real < n).all()            # row == id here: no padding id surfaces
    assert np.array_equal(got[1] == SENTINEL_ID, want[1] == SENTINEL_ID)
    assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                          segmented_tolerance(idx, q))


@pytest.mark.parametrize("kind", ["crumb", "sign"])
@pytest.mark.parametrize("n", [1024, 1021])
@pytest.mark.parametrize("shards", [4, 7])
def test_sharded_search_equals_four_device_reference(four_device, shards, n, kind):
    out, res = four_device
    path = str(out / f"{kind}_{n}.mvec")
    sh = ShardedMonaVec.load(path, mesh=Mesh.repeat("cpu", shards), device="cpu")
    assert sh.mesh.size == shards and len(sh.shards) == shards
    assert (sh.tuned is not None) == (kind == "sign") and sh.meta is not None
    ref, idx = RefMonaVec.load(path), MonaVec.load(path, device="cpu")
    q = rsyn.queries_from_corpus(rsyn.embedding_corpus(51, n, DIM), 52, NQ)
    cases = _CASES[kind] if shards == 4 else _INVARIANT[kind]
    for name in cases:
        before = obs.registry().snapshot()
        got = sh.search(q, 10, **_kwargs(name, n, Eq))
        boosts = obs.counter_total(obs.counter_deltas(obs.registry().snapshot(), before),
                                   "engine.boost_applied")
        assert boosts == (1 if name.startswith("boost") else 0), name
        want = (res[f"{kind}_{n}_{name}_s"], res[f"{kind}_{n}_{name}_i"])
        _check(got, want, n, ref, q, idx)
        if name == "few":
            assert (got[1] == SENTINEL_ID).sum() == NQ * (10 - 3)
        if name in ("rm_full", "off"):
            # The m >= n collapse and rescore_mult=0 are the full scan, byte for byte.
            assert got[0].tobytes() == idx.search(q, 10, rescore_mult=0)[0].tobytes()


@pytest.mark.parametrize("shards", [4, 7])
def test_k_above_n_pads_with_sentinels(four_device, shards):
    out, res = four_device
    sh = ShardedMonaVec.load(str(out / "tiny.mvec"), mesh=Mesh.repeat("cpu", shards),
                             device="cpu")
    q = rsyn.queries_from_corpus(rsyn.embedding_corpus(53, 13, DIM), 54, NQ)
    got = sh.search(q, 20)
    assert got[1].shape == (NQ, 20) and (got[1][:, 13:] == SENTINEL_ID).all()
    assert (got[0][:, 13:] == NEG).all()
    ref = RefMonaVec.load(str(out / "tiny.mvec"))
    _check(got, (res["tiny_s"], res["tiny_i"]), 13, ref, q, MonaVec.load(str(out / "tiny.mvec"),
                                                                           device="cpu"))
    assert np.array_equal(got[0][:, 13:], res["tiny_s"][:, 13:])


@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("shards", [4, 7])
def test_f32_variant_equals_four_device_reference(four_device, shards, metric):
    _, res = four_device
    cand, user = res["f32_cand"], res["f32_user"]
    got = make_scan_topk_f32_shardmap(Mesh.repeat("cpu", shards), metric=metric, k=5)(
        torch.from_numpy(user), torch.from_numpy(cand))
    want_s, want_i = res[f"f32_{metric}_s"], res[f"f32_{metric}_i"]
    np.testing.assert_array_equal(got[1].numpy(), want_i)
    # Exact f32 scores: the same sums in another order, within 1e-5 of |q||v|.
    bound = 1e-5 * np.abs(user).sum(1)[:, None] * np.abs(cand).max() * 4 + 1e-6
    assert (np.abs(got[0].numpy() - want_s) <= bound).all()
    whole = scan_topk_f32(torch.from_numpy(user), torch.from_numpy(cand), metric=metric, k=5)
    assert torch.equal(whole[1], got[1])


# ---------------------------------------------------------------------------
# Knobs, rejections, serving.
# ---------------------------------------------------------------------------

def test_tuned_knobs_and_boost_follow_the_tune_result():
    """A tuned ``rescore_mult`` is the default, an explicit keyword wins, the
    boost widens it by the mask's exact popcount, and every choice gives the
    plan of the explicit knob it resolves to."""
    x = synthetic.embedding_corpus(14, 600, DIM)
    sh = MonaVec.build(x, coarse="sign", device="cpu").shard(Mesh.repeat("cpu", 3))
    q = synthetic.queries_from_corpus(x, 15, NQ)
    plain = {kw: sh.search(q, 10, rescore_mult=kw) for kw in (2, 4, 8)}
    sh.tuned = TuneResult(recall_target=0.9, k=10, n_queries=8, seed=1, met_target=True,
                          knobs={"rescore_mult": 2}, ladder={},
                          boost=BoostCurve(points=(BoostPoint(0.05, 4, 1.0),
                                                   BoostPoint(0.25, 2, 1.0))))
    assert np.array_equal(sh.search(q, 10)[1], plain[2][1])
    assert np.array_equal(sh.search(q, 10, rescore_mult=8)[1], plain[8][1])
    rows = np.arange(600)
    for mask, rm in ((rows % 40 == 0, 8), (rows % 5 == 0, 4), (rows % 2 == 0, 2)):
        sh.tuned, tuned = None, sh.tuned
        want = sh.search(q, 10, where_mask=mask, rescore_mult=rm)
        sh.tuned = tuned
        assert np.array_equal(sh.search(q, 10, where_mask=mask)[1], want[1]), rm
    with pytest.raises(ValueError, match="rescore_mult must be >= 0"):
        sh.search(q, 10, rescore_mult=-1)
    with pytest.raises(ValueError, match="binarized coarse code"):
        MonaVec.build(x, device="cpu").shard().search(q, 10, rescore_mult=2)


def _message(fn) -> str:
    with pytest.raises(TypeError) as e:
        fn()
    return str(e.value)


def test_shard_rejections_carry_the_reference_errors(tmp_path):
    x = rsyn.embedding_corpus(16, 64, 16)
    idx = MonaVec.build(x, device="cpu")
    idx.delete([3])
    ref = RefMonaVec.build(jnp.asarray(x))
    ref.delete([3])
    assert _message(idx.shard) == _message(ref.shard)
    # A mutated file loaded sharded raises too (its base segment alone would
    # drop the added rows and serve the tombstoned ones).
    idx.save(str(tmp_path / "mutated.mvec"))
    assert _message(lambda: ShardedMonaVec.load(str(tmp_path / "mutated.mvec"),
                                                device="cpu")) == _message(ref.shard)
    for kind, kw in (("ivf", {"nlist": 4}), ("hnsw", {"m": 4, "ef_construction": 8})):
        port = MonaVec.build(x, index=kind, device="cpu", **kw)
        want = _message(lambda: RefMonaVec.build(jnp.asarray(x), index=kind, **kw).shard())
        assert _message(port.shard) == want
        assert _message(lambda: ShardedMonaVec.shard(port.backend)) == want


def test_sharded_index_serves_through_the_registry_and_batcher():
    x = synthetic.embedding_corpus(17, 700, DIM)
    g = np.arange(700) % 4
    sh = MonaVec.build(x, meta={"g": g}, device="cpu").shard(Mesh.repeat("cpu", 4))
    q = synthetic.queries_from_corpus(x, 18, 11)
    reg = TenantRegistry()
    reg.put("tok", "docs", sh)
    search = reg.searcher("tok", "docs", k=5, where=Eq("g", 2)).warmup(11)
    want = sh.search(q, 5, where=Eq("g", 2))
    got = search(q)
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    assert (g[got[1].astype(np.int64)] == 2).all()
    batcher = engine.MicroBatcher(reg)
    tickets = [batcher.submit("tok", "docs", q[i:i + 4], k=5, where=Eq("g", 2))
               for i in range(0, 11, 4)]
    assert batcher.flush() == 1
    assert np.array_equal(np.concatenate([t.result()[1] for t in tickets]), want[1])
    plain = sh.searcher(k=3).warmup(2)(q[:2])
    assert plain[1].shape == (2, 3)


def test_graph_path_captures_once_per_plan(monkeypatch):
    """On the card's path (stand-in captures on the CPU): a plan captures
    once and lives with the sharded index; a new mask, or a batch of the same
    bucket, replays it; a second sharded index of the same corpus shares the
    plan, not the graph."""
    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Graph", _FakeGraph)
    x = synthetic.embedding_corpus(19, 500, DIM)
    idx = MonaVec.build(x, coarse="crumb", device="cpu")
    sh = idx.shard(Mesh.repeat("cpu", 4))
    q = synthetic.queries_from_corpus(x, 20, 6)
    stats = engine.plan_cache().stats
    before = stats.snapshot()
    first = sh.search(q, 10, where_mask=np.arange(500) % 2 == 0)
    assert stats.since(before).captures == 1 and len(sh.graphs) == 1
    before = stats.snapshot()
    again = sh.search(q[:5], 10, where_mask=np.arange(500) % 3 == 0)
    sh.search(q, 10, where_mask=np.arange(500) % 2 == 0, rescore_mult=2)
    assert stats.since(before).captures == 1 and len(sh.graphs) == 2
    assert np.array_equal(first[1], idx.search(q, 10, where_mask=np.arange(500) % 2 == 0)[1])
    assert np.array_equal(again[1], idx.search(q[:5], 10, where_mask=np.arange(500) % 3 == 0)[1])
    other = idx.shard(Mesh.repeat("cpu", 4))
    before = stats.snapshot()
    other.search(q, 10, where_mask=np.arange(500) % 2 == 0)
    d = stats.since(before)
    assert d.captures == 1 and d.misses == 0 and len(other.graphs) == 1


class _StandInCapture:
    """A stand-in for ``plan._Captured`` on the CPU: "captures" by running
    ``fn`` once, "replays" by running it again into the same outputs."""

    def __init__(self, fn, dev):
        self.fn, self.out, self.tally = fn, fn(), {}

    def replay(self):
        def write(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            else:
                for d, s in zip(dst, src):
                    write(d, s)
        write(self.out, self.fn())


class _Stream:
    waited = 0

    def wait_event(self, event):
        _Stream.waited += 1


class _Event:
    def record(self):
        pass


@dataclasses.dataclass(frozen=True)
class _TwoGroups(Mesh):
    """Shards 0-1 and 2-3 as two device groups: the several-device plan."""

    @property
    def groups(self):
        return ((self.devices[0], (0, 1)), (self.devices[2], (2, 3)))


def test_several_device_graphs_with_stand_ins(monkeypatch):
    """``_MeshGraph`` (a graph per device group, an event each, the first
    device's stream waiting on all, the candidates copied there, the merge's
    graph) with stand-in captures on the CPU: the bytes of the same shards'
    stages run eagerly, one capture per plan, none for a new mask."""
    x = synthetic.embedding_corpus(22, 501, DIM)
    idx = MonaVec.build(x, coarse="sign", device="cpu")
    q = synthetic.queries_from_corpus(x, 23, 6)
    masks = [np.arange(501) % 3 == 0, np.arange(501) % 7 == 2]
    cases = [{}, {"where_mask": masks[0]}, {"where_mask": masks[1]}, {"rescore_mult": 3},
             {"rescore_mult": 3, "where_mask": masks[0]}]
    eager = idx.shard(Mesh.repeat("cpu", 4))
    want = [eager.search(q, 10, **kw) for kw in cases]
    for name, value in (("_on_card", lambda dev: True), ("_Captured", _StandInCapture),
                        ("_warm_up", lambda dev, fn: fn()), ("_wait", lambda: None),
                        ("_pinned", lambda like: torch.empty(like.shape, dtype=like.dtype))):
        monkeypatch.setattr(plan_mod, name, value)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    sh = idx.shard(_TwoGroups(Mesh.repeat("cpu", 4).devices))
    assert len(sh.perms) == 0 and len(sh.bound(False)) == 4 * 2 + 2
    stats = engine.plan_cache().stats
    before = stats.snapshot()
    _Stream.waited = 0
    for kw, w in zip(cases, want):
        got = sh.search(q, 10, **kw)
        assert got[0].tobytes() == w[0].tobytes() and np.array_equal(got[1], w[1]), kw
    # Full, filtered (both masks), cascade, filtered cascade: four plans.
    assert stats.since(before).captures == 4
    assert {type(g).__name__ for g in sh.graphs.values()} == {"_MeshGraph"}
    assert _Stream.waited == 2 * len(cases)           # one wait per group each search


# ---------------------------------------------------------------------------
# The module gaps: PerDimWhiten, score_packed_ref, pixel_corpus.
# ---------------------------------------------------------------------------

def test_pixel_corpus_equals_reference():
    np.testing.assert_array_equal(synthetic.pixel_corpus(3, 200, 40),
                                  rsyn.pixel_corpus(3, 200, 40))


def test_per_dim_whiten_equals_reference():
    x = rsyn.pixel_corpus(4, 300, 24)
    want = rstd.PerDimWhiten.fit(jnp.asarray(x))
    got = standardize.PerDimWhiten.fit(torch.from_numpy(x))
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.inv_std, want.inv_std)
    assert got.mean.dtype == np.float32 and got.inv_std.dtype == np.float32
    np.testing.assert_allclose(got.transform(torch.from_numpy(x)).numpy(),
                               np.asarray(want.transform(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_score_packed_ref_equals_reference(metric):
    x = rsyn.embedding_corpus(21, 200, 48)
    enc = rqz.encode(jnp.asarray(x), metric=metric, seed=9)
    q = rqz.encode_query(jnp.asarray(x[:5] + 0.01), enc)
    packed, qnorms = np.asarray(enc.packed), np.asarray(enc.qnorms)
    tenc = encoded_from_arrays(packed, qnorms, seed=enc.seed, metric=metric, bits=4,
                               dim=enc.dim, dim_pad=enc.dim_pad, device="cpu")
    got = scoring.score_packed_ref(torch.from_numpy(np.asarray(q)), tenc).numpy()
    want = np.asarray(rscoring.score_packed_ref(q, enc))
    tol = adjusted_tolerance(dot_tolerance(np.asarray(q), packed), qnorms, metric)
    assert got.shape == (5, 200) and (np.abs(got - want) <= tol).all()
