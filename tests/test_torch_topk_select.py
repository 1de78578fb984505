"""The top-k select (``kernels.topk_select``) on the CPU: ``scoring.topk``
with and without a live mask, routed by shape, against a masked fill and the
stable descending sort, byte for byte; the plain version at several chunk
sizes; the BruteForce plan's ``select_all`` through it; and what the CUDA
wrapper refuses before any build.  ``chip_smoke.py`` holds the kernel itself
against the sort on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch import MonaVec, engine
from repro_torch.core import scoring
from repro_torch.core.allowlist import NEG
from repro_torch.kernels import cuda_build
from repro_torch.kernels import topk_select as sel
from tests.torch_harness import (assert_segmented_search_matches, port_stream,
                                 reference_over_port, reference_stream)

W = 4_097    # four of the smallest 1,024-column chunks (chunk_plan) and one column


def _ties(rng, b, w):
    return rng.randint(-3, 4, size=(b, w)).astype(np.float32)


def _specials(rng, b, w):
    pick = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, NEG, 1.0, -1.0, 3.0e38],
                    np.float32)
    return pick[rng.randint(0, len(pick), size=(b, w))]


# name: (rows, width, k, values, live share (None: no mask), taken by the select)
CASES = {
    "ties_k1": (5, W + 37, 1, _ties, None, True),
    "ties_k10_live": (5, W + 37, 10, _ties, 0.5, True),
    "ties_k64_live": (3, 2 * W + 3, 64, _ties, 0.5, True),
    "all_neg_rows_k64": (4, W + 1, 64, lambda rng, b, w: np.full((b, w), NEG, np.float32),
                         None, True),
    "all_dead_k10": (4, W + 5, 10, _ties, 0.0, True),
    "three_live_k10": (4, W + 5, 10, _ties, 3, True),
    "mostly_dead_k64": (6, 3 * W - 11, 64,
                        lambda rng, b, w: rng.randn(b, w).astype(np.float32), 0.03, True),
    "zeros_infs_nan_k64": (4, W + 9, 64, _specials, 0.5, True),
    "narrow_320_k10_live": (6, 320, 10, _ties, 0.5, True),
    "beam_96_k64_keeps_sort": (4, 96, 64, _specials, 0.5, False),
    "router_8_k2": (7, 8, 2, lambda rng, b, w: rng.randn(b, w).astype(np.float32), None, True),
    "width_equals_k32": (3, 32, 32, _specials, None, True),
    "k33_at_sort_w_keeps_sort": (4, sel.SORT_W, 33, _ties, 0.5, False),
    "k33_past_sort_w": (4, sel.SORT_W + 1, 33, _ties, 0.5, True),
    "width_3_k1": (5, 3, 1, _specials, 0.5, True),
    "narrow_keeps_sort": (4, 40, 64, _ties, 0.5, False),    # narrower than k
    "k_above_k_max_keeps_sort": (3, W + 37, sel.K_MAX + 1, _ties, 0.5, False),
    "f64_keeps_sort": (3, W + 37, 10, lambda rng, b, w: _ties(rng, b, w).astype(np.float64),
                       0.5, False),
    "3d_keeps_sort": (3, W + 37, 10, lambda rng, b, w: _ties(rng, b, w)[None], None, False),
}


def _live(rng, w, share):
    if share is None:
        return None
    if isinstance(share, int):    # exactly this many live columns
        mask = np.zeros(w, bool)
        mask[rng.choice(w, share, replace=False)] = True
        return torch.from_numpy(mask)
    return torch.from_numpy(rng.rand(w) < share)


def _masked_sort(scores, k, live):
    if live is not None:
        scores = scores.masked_fill(~live, float(NEG))
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.numpy().tobytes() == y.numpy().tobytes() for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_topk_equals_the_masked_stable_sort(case, monkeypatch):
    """``scoring.topk(scores, k, live=)`` equals masked_fill + the stable
    sort byte for byte (ties, NEG rows, fewer than k live, +-0.0, +-inf,
    NaN), and goes to the select (its plain version here) exactly where its
    shape fits, ragged widths included."""
    b, w, k, values, share, taken = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    scores = torch.from_numpy(values(rng, b, w))
    live = _live(rng, w, share)
    calls = []
    real = sel.select

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(sel, "select", spy)
    want = _masked_sort(scores, k, live)
    assert _same(scoring.topk(scores, k, live=live), want)
    assert bool(calls) == taken == sel.fits(scores, k)
    if taken:
        chunk, chunks = sel.chunk_plan(b, w)
        assert chunk % 4 == 0 and (chunks - 1) * chunk < w <= chunks * chunk


@pytest.mark.parametrize("mutated", [False, True])
def test_select_all_through_the_select(mutated, monkeypatch):
    """The BruteForce plan's finalize (``select_all``), its live mask handed
    to ``scoring.topk``: through the select and through the sort (``fits``
    refusing every row) it returns the same bytes, and the reference's
    results."""
    rng = np.random.RandomState(31)
    with port_stream(reference_stream()):
        idx = MonaVec.build(rng.randn(300, 32).astype(np.float32), device="cpu")
        if mutated:
            idx.add(rng.randn(40, 32).astype(np.float32))
            idx.delete(idx.ids[::5])
        q = rng.randn(8, 32).astype(np.float32)
        mut = None if idx.mut.is_static else idx.mut
        with monkeypatch.context() as m:
            m.setattr(sel, "fits", lambda scores, k: False)
            by_sort = engine.search_eager(idx.backend, mut, q, 12, bucketed=False)
        calls = []
        real = sel.select
        monkeypatch.setattr(sel, "select", lambda *a: calls.append(a) or real(*a))
        by_select = engine.search_eager(idx.backend, mut, q, 12, bucketed=False)
        assert calls
        assert by_sort[0].tobytes() == by_select[0].tobytes()
        assert by_sort[1].tobytes() == by_select[1].tobytes()
        assert_segmented_search_matches(idx, reference_over_port(idx), q, 12)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "k", "live"])
def test_topk_select_cuda_refuses_before_building(bad, monkeypatch):
    def no_build(name):
        raise AssertionError("built")
    monkeypatch.setattr(cuda_build, "load", no_build)
    scores = torch.zeros(2, 100)
    args = {"cpu": (scores, 10), "dtype": (scores.double(), 10), "k": (scores, 0),
            "live": (scores, 10)}[bad]
    if bad != "cpu":    # a stand-in CUDA tensor: only its attributes are read
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    live = torch.ones(99, dtype=torch.bool) if bad == "live" else None
    with pytest.raises(ValueError):
        sel.topk_select_cuda(*args, live=live)
