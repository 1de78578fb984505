"""The port's hybrid dense + BM25 search with RRF fusion on the CPU, against
the reference's live output (paper §3.6).

* ``tokenize``, the postings, ``score``, ``search`` (with and without an
  allowlist) and ``rrf_fuse`` are equal to the reference's, byte for byte,
  on docs with non-ASCII terms;
* ``HybridIndex.search`` single (1-D) and batched ([b, k], padded with id -1
  / 0.0) equals the reference's over one dense encoding, with ``fetch_k``,
  ``rrf_k``, an allowlist and a ``where=`` predicate that filters both
  channels;
* ``MicroBatcher.submit(..., text=)`` coalesces hybrid requests and each
  gets the rows of the direct batched search, as the reference's batcher.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro import engine as rengine
from repro.core import HybridIndex as RefHybridIndex
from repro.core import TenantRegistry as RefTenantRegistry
from repro.core import bm25 as rbm25
from repro.core import rrf as rrrf
from repro.core.allowlist import Allowlist as RefAllowlist
from repro.core.predicate import Eq as RefEq
from repro_torch import engine
from repro_torch.core import bm25 as tbm25
from repro_torch.core import rrf as trrf
from repro_torch.core.allowlist import Allowlist
from repro_torch.core.bm25 import Bm25Index
from repro_torch.core.bruteforce import BruteForceIndex
from repro_torch.core.convert import encoded_from_arrays
from repro_torch.core.hybrid import HybridIndex
from repro_torch.core.metadata import MetaStore
from repro_torch.core.predicate import Eq
from repro_torch.core.tenancy import TenantRegistry
from tests.torch_harness import port_stream, reference_stream

DIM = 32
WORDS = ("alpha", "beta", "gamma", "delta", "café", "naïveté", "北京", "大学", "straße",
         "x_y", "Hello123", "über")


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _docs(rng, n):
    """Seeded docs: a topic word per row, shared filler and non-ASCII terms."""
    return [" ".join([f"topic{i % 7}"] + list(rng.choice(WORDS, rng.randint(1, 8))))
            for i in range(n)]


def _pair(seed: int, n: int = 300, meta: bool = False):
    """A reference HybridIndex and the port's over the same dense encoding."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, DIM).astype(np.float32)
    docs = _docs(rng, n)
    cols = {"cat": np.array(["a", "b", "c"])[np.arange(n) % 3]} if meta else None
    ref = RefHybridIndex.build(jnp.asarray(x), docs, metric="cosine", meta=cols)
    enc = ref.dense.enc
    dense = BruteForceIndex(enc=encoded_from_arrays(
        np.asarray(enc.packed), np.asarray(enc.qnorms), seed=enc.seed, metric=enc.metric,
        bits=enc.bits, dim=enc.dim, dim_pad=enc.dim_pad, device="cpu"), ids=ref.dense.ids)
    port = HybridIndex(dense=dense, sparse=Bm25Index.build(docs),
                       meta=MetaStore.build(cols, n) if meta else None)
    return ref, port, rng, x


def test_tokenize_postings_and_scores_equal_the_reference():
    rng = np.random.RandomState(61)
    docs = _docs(rng, 80) + ["Café au lait", "北京 naïve test_case Hello123", ""]
    for text in docs[-3:] + ["Alpha-Beta_gamma 42"]:
        assert tbm25.tokenize(text) == rbm25.tokenize(text)
    t, r = tbm25.Bm25Index.build(docs), rbm25.Bm25Index.build(docs)
    assert list(t.postings) == list(r.postings)
    for term in r.postings:
        for a, b in zip(t.postings[term], r.postings[term]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t.doc_len.tobytes() == r.doc_len.tobytes() and t.avg_len == r.avg_len
    mask = np.arange(len(docs)) % 4 != 1
    for query in ("topic3 alpha", "café 北京 missing", "beta beta gamma", "nothing"):
        assert t.score(query).tobytes() == r.score(query).tobytes()
        for allow in (None, mask):
            for got, want in zip(t.search(query, 12, allow_mask=allow),
                                 r.search(query, 12, allow_mask=allow)):
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_rrf_fuse_equals_the_reference():
    rng = np.random.RandomState(62)
    for _ in range(20):
        lists = [rng.choice(50, rng.randint(0, 30), replace=False) for _ in range(2)]
        for k, top in ((60, 10), (1, 5), (60, 100)):
            got = trrf.rrf_fuse(lists, k=k, top_k=top)
            want = rrrf.rrf_fuse(lists, k=k, top_k=top)
            assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes()
                       for g, w in zip(got, want))
    # Ties go to the smaller id in both.
    assert trrf.rrf_fuse([np.array([5, 3]), np.array([3, 5])])[1].tolist() == [3, 5]


def _same(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
               for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [{}, {"fetch_k": 7, "rrf_k": 10}, {"k": 25}])
def test_search_single_and_batched_equal_the_reference(kw):
    ref, port, rng, x = _pair(63)
    k = kw.pop("k", 10)
    q = x[:6] + 0.05 * rng.randn(6, DIM).astype(np.float32)
    texts = ["topic1 alpha", "café", "北京 大学 topic4", "nothing here", "beta", "über topic6"]
    got = port.search(q, texts, k, **kw)
    want = ref.search(jnp.asarray(q), texts, k, **kw)
    assert got[0].shape == (6, k) and _same(got, want)
    for i in (0, 3):
        single = port.search(q[i], texts[i], k, **kw)
        assert single[0].ndim == 1 and _same(single, ref.search(jnp.asarray(q[i]), texts[i],
                                                               k, **kw))
        n = single[1].shape[0]
        assert got[1][i, :n].tobytes() == single[1].tobytes()
        assert (got[1][i, n:] == -1).all()


def test_allowlist_and_where_filter_both_channels():
    ref, port, rng, x = _pair(64, meta=True)
    q = x[10:14] + 0.05 * rng.randn(4, DIM).astype(np.float32)
    texts = ["topic2 gamma", "alpha", "naïveté", "topic5"]
    mask = np.arange(300) % 5 == 0
    got = port.search(q, texts, 8, allow=Allowlist(mask=mask, n_allowed=int(mask.sum())))
    want = ref.search(jnp.asarray(q), texts, 8,
                      allow=RefAllowlist(mask=mask, n_allowed=int(mask.sum())))
    assert _same(got, want)
    assert (got[1].astype(np.int64) % 5 == 0).all()
    got = port.search(q, texts, 8, where=Eq("cat", "a"))
    want = ref.search(jnp.asarray(q), texts, 8, where=RefEq("cat", "a"))
    assert _same(got, want)
    real = got[1][got[1] >= 0]
    assert real.size and (real % 3 == 0).all()
    with pytest.raises(ValueError, match="metadata"):
        _pair(65)[1].search(q, texts, 8, where=Eq("cat", "a"))
    with pytest.raises(ValueError, match="query texts"):
        port.search(q, texts[:2], 8)


def test_batcher_text_groups_coalesce_as_the_reference():
    ref, port, rng, x = _pair(66, n=120)
    regs = (TenantRegistry(), RefTenantRegistry())
    regs[0].put("a", "docs", port)
    regs[1].put("a", "docs", ref)
    batchers = (engine.MicroBatcher(regs[0]), rengine.MicroBatcher(regs[1], use_kernel=False))
    q = x[:5] + 0.05 * rng.randn(5, DIM).astype(np.float32)
    results = []
    for mb in batchers:
        tickets = [mb.submit("a", "docs", q[:2], k=6, text=["topic1", "alpha beta"]),
                   mb.submit("a", "docs", q[2:3], k=6, text="café"),
                   mb.submit("a", "docs", q[3:5], k=6, text="topic3 北京")]
        assert mb.flush() == 1
        results.append([t.result() for t in tickets])
    direct = port.search(q, ["topic1", "alpha beta", "café", "topic3 北京", "topic3 北京"], 6)
    off = 0
    for got, want in zip(*results):
        assert _same(got, want)
        n = got[1].shape[0]
        assert _same(got, (direct[0][off: off + n], direct[1][off: off + n]))
        off += n
