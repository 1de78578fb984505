"""The port's filtered search and its v9 / v10 files on the CPU against the
reference (DESIGN.md §8).

The same numpy inputs go through ``repro`` and ``repro_torch``:

* a filtered search runs both packages over one set of segments (the port's
  through ``convert``), so ids may differ only where scores tie within the
  f32 rule (``torch_harness.dot_tolerance``), sentinel slots are equal, and
  the port's filtered search equals its own search with the
  ``Allowlist(evaluate(p))`` oracle byte for byte.

Here the full scans (4-bit, 2-bit x cosine, dot, l2, static and mutated);
the cascades, the engine's handling of predicates and the v9 / v10 files are
in tests/test_torch_filtered_cascade.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import MonaVec as RefMonaVec
from repro_torch.core import predicate as tpred
from repro_torch.core.allowlist import Allowlist
from repro_torch.core.convert import meta_from_arrays
from repro_torch.core.predicate import Eq, Ge, In, Lt, Ne
from tests.torch_harness import (SENTINEL, assert_search_matches, port_over_reference,
                                 port_stream, reference_full_scores, reference_stream,
                                 segmented_tolerance)
from tests.test_torch_predicate import I64_MAX, _columns, _to_ref

DIM = 24


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _port_meta(ref_meta):
    return meta_from_arrays({name: (c.kind, c.values, c.vocab)
                             for name, c in ref_meta.columns.items()})


# ---------------------------------------------------------------------------
# Filtered search against the reference and the allowlist oracle.
# ---------------------------------------------------------------------------

def _vecs(rng, n, dim=DIM):
    return (rng.randn(n, dim) * 2 + 0.3).astype(np.float32)


def _pair(metric, bits, mutated, coarse=None, seed=7):
    """(port, reference) over one encoding, with the same metadata."""
    rng = np.random.RandomState(seed)
    n = 120
    ref = RefMonaVec.build(jnp.asarray(_vecs(rng, n)), metric=metric, bits=bits,
                           meta=_columns(n, seed), coarse=coarse)
    if mutated:
        extra = _columns(30, seed + 1)
        ref.add(jnp.asarray(_vecs(rng, 30)), meta=extra)
        ref.delete(np.concatenate([ref.ids[::9], ref.ids[120::7]]))
    idx = port_over_reference(ref)
    idx.meta = _port_meta(ref.meta)
    return idx, ref, rng


def _filtered_matches(idx, ref, q, k, p, **kw):
    """The port against the reference under the tolerance rule, and against
    its own allowlist oracle byte for byte; every returned id satisfies p."""
    got = idx.search(q, k, where=p, **kw)
    want = ref.search(jnp.asarray(q), k, where=_to_ref(p), **kw)
    assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
    assert_search_matches(got, want, reference_full_scores(ref, q), idx.ids,
                          segmented_tolerance(idx, q))
    mask = tpred.evaluate(p, idx.meta)
    oracle = idx.search(q, k, allow=Allowlist(mask=mask, n_allowed=int(mask.sum())), **kw)
    assert got[0].tobytes() == oracle[0].tobytes() and got[1].tobytes() == oracle[1].tobytes()
    allowed = set(idx.ids[mask].tolist())
    assert all(int(i) in allowed for i in got[1].ravel() if i != SENTINEL)
    return got


PREDICATES = [Eq("s", "red"), Eq("s", "red") & Lt("i", 10),
              Ge("f", 0.0) | In("s", ["green", "cyan"]), ~In("s", ["red", "blue"]) &
              Ne("i", I64_MAX)]


@pytest.mark.parametrize("mutated", [False, True], ids=["static", "mutated"])
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_filtered_full_scan_matches_reference(metric, bits, mutated):
    idx, ref, rng = _pair(metric, bits, mutated)
    q = _vecs(rng, 5)
    for p in PREDICATES:
        _filtered_matches(idx, ref, q, 8, p)
