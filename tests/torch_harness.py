"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Both packages get the same numpy inputs; the port runs on the CPU, where
each kernel wrapper takes its plain version.  Tolerances follow the port's
stated rule for f32 dot products: |diff| <= 1e-5 * sum_i |q_i * deq_i| + 1e-6,
with deq the 4-bit or 2-bit centroid of each dim's code.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import torch

from repro_torch.core import lloydmax as tlm
from repro_torch.core import quantize as tqz
from repro_torch.core import rhdh as trhdh


@contextlib.contextmanager
def port_stream(partitionable: bool):
    """Run the port on one threefry stream, restoring its setting after."""
    old = trhdh.THREEFRY_PARTITIONABLE
    trhdh.THREEFRY_PARTITIONABLE = partitionable
    try:
        yield
    finally:
        trhdh.THREEFRY_PARTITIONABLE = old


@contextlib.contextmanager
def jax_stream(partitionable: bool):
    """Run JAX on one threefry stream, restoring its flag after, so no other
    test in this worker sees it changed."""
    old = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def reference_stream() -> bool:
    """The stream the reference draws its signs from in this process."""
    return bool(jax.config.jax_threefry_partitionable)


def unpack_codes(packed: np.ndarray, bits: int = 4, n4_dims: int = 0):
    """Per-dim codes [..., d'] (int64) of packed rows of any bit mode, and
    each dim's width [d'] (4 or 2)."""
    t = torch.tensor(np.ascontiguousarray(packed))
    if bits == 4:
        codes = tqz.unpack_4bit(t)
    elif bits == 2:
        codes = tqz.unpack_2bit(t)
    else:
        b4 = n4_dims // 2
        codes = torch.cat([tqz.unpack_4bit(t[..., :b4]), tqz.unpack_2bit(t[..., b4:])], dim=-1)
    d = codes.shape[-1]
    widths = np.full(d, 4 if bits == 4 else 2)
    if bits == 3:
        widths[:n4_dims] = 4
    return codes.numpy().astype(np.int64), widths


def dot_tolerance(q_rot: np.ndarray, packed: np.ndarray, bits: int = 4,
                  n4_dims: int = 0) -> np.ndarray:
    """[b, n] bound 1e-5 * sum_i |q_i * deq_i| + 1e-6 on a raw score of
    packed rows of any bit mode."""
    codes, widths = unpack_codes(packed, bits, n4_dims)
    absdeq = np.where(widths == 4, np.abs(tlm.CENTROIDS_4BIT)[codes],
                      np.abs(tlm.CENTROIDS_2BIT)[np.minimum(codes, 3)])
    return 1e-5 * (np.abs(q_rot).astype(np.float64) @ absdeq.T.astype(np.float64)) + 1e-6


def code_flip_rows(got_packed: np.ndarray, want_packed: np.ndarray, want_rot: np.ndarray,
                   prepared: np.ndarray, bits: int = 4, n4_dims: int = 0) -> np.ndarray:
    """Check codes of any bit mode against the reference's; return the rows
    that differ.

    A code may differ only by one level, and only where the reference's
    rotated value (``want_rot``, in the packed dim order) lies on the
    boundary between the two levels to within the rotation's rounding
    (1e-5 * |prepared row|_1 + 1e-6): there another summation order may
    round to the neighbouring level.
    """
    got, widths = unpack_codes(got_packed, bits, n4_dims)
    want, _ = unpack_codes(want_packed, bits, n4_dims)
    rows, cols = np.nonzero(got != want)
    if rows.size:
        assert np.all(np.abs(got[rows, cols] - want[rows, cols]) == 1)
        lower = np.minimum(got[rows, cols], want[rows, cols])
        edge = np.where(widths[cols] == 4, tlm.BOUNDARIES_4BIT[np.minimum(lower, 14)],
                        tlm.BOUNDARIES_2BIT[np.minimum(lower, 2)])
        tol = 1e-5 * np.abs(prepared).sum(axis=1)[rows] + 1e-6
        assert np.all(np.abs(want_rot[rows, cols] - edge) <= tol)
    return np.unique(rows)


def adjusted_tolerance(raw_tol: np.ndarray, qnorms: np.ndarray, metric: str) -> np.ndarray:
    """Carry a raw-score bound through the metric adjustment; the l2 term
    also covers the norms' own last-bit differences (rtol 1e-6)."""
    if metric == "cosine":
        return raw_tol / np.maximum(qnorms, 1e-12)[None, :]
    if metric == "l2":
        return raw_tol + 1e-6 * (qnorms * qnorms)[None, :]
    return raw_tol


def assert_search_matches(port, ref, ref_full, ids, tol):
    """Ids equal except where the reference scores of the two ids tie within
    ``tol``; scores equal within ``tol``.

    port, ref: (scores [b, k], ids [b, k]); ref_full: reference scores
    [b, n] of every row; ids: [n] external ids; tol: [b, n] bounds.
    """
    p_scores, p_ids = port
    r_scores, r_ids = ref
    row_of = {int(v): i for i, v in enumerate(ids)}
    assert p_ids.shape == r_ids.shape and p_ids.dtype == np.uint64
    for b in range(r_ids.shape[0]):
        for j in range(r_ids.shape[1]):
            if r_ids[b, j] == p_ids[b, j]:
                row = row_of.get(int(r_ids[b, j]))
                t = 1e-6 if row is None else tol[b, row]
                assert abs(float(p_scores[b, j]) - float(r_scores[b, j])) <= t, (b, j)
                continue
            # A swap is allowed only between rows whose scores tie within tol.
            prow, rrow = row_of[int(p_ids[b, j])], row_of[int(r_ids[b, j])]
            t = tol[b, prow] + tol[b, rrow]
            assert abs(float(ref_full[b, prow]) - float(r_scores[b, j])) <= t, (b, j)
            assert abs(float(p_scores[b, j]) - float(r_scores[b, j])) <= t, (b, j)


# ---------------------------------------------------------------------------
# Segmented indexes in both packages over one encoding.
# ---------------------------------------------------------------------------

def _segments_of(idx):
    """[(enc, ids, tombs)] of either package's MonaVec, base first."""
    return ([(idx.backend.enc, idx.backend.ids, idx.mut.base_tombs)]
            + [(s.enc, s.ids, s.tombs) for s in idx.mut.extras])


def port_over_reference(ref):
    """The port's MonaVec over the reference's segments, ids, tombstones and
    next ordinal (``convert.segmented_from_arrays``), with its autotune
    result (``convert.tune_from_fields``); coarse codes derived by the
    port."""
    from repro_torch.core.convert import segmented_from_arrays, tune_from_fields

    enc = ref.backend.enc
    std = enc.std
    segs = [{"packed": np.asarray(e.packed), "qnorms": np.asarray(e.qnorms), "seed": e.seed,
             "ids": ids, "tombs": tombs} for e, ids, tombs in _segments_of(ref)]
    idx = segmented_from_arrays(
        segs, next_ordinal=ref.mut.next_ordinal, metric=enc.metric, bits=enc.bits,
        dim=enc.dim, dim_pad=enc.dim_pad, n4_dims=enc.n4_dims, perm=enc.perm,
        std_mean=None if std is None else std.mean,
        std_inv_std=None if std is None else std.inv_std, coarse=enc.coarse, device="cpu")
    idx.tuned = tune_from_fields(ref.tuned)
    return idx


def reference_tune(tune):
    """The reference's TuneResult with the fields of the port's (or None)."""
    from repro.tune.result import BoostCurve, BoostPoint, KnobRung, TuneResult

    if tune is None:
        return None
    boost = None if tune.boost is None else BoostCurve(points=tuple(
        BoostPoint(p.selectivity, p.mult, p.recall) for p in tune.boost.points))
    return TuneResult(recall_target=tune.recall_target, k=tune.k, n_queries=tune.n_queries,
                      seed=tune.seed, met_target=tune.met_target, knobs=dict(tune.knobs),
                      ladder={name: tuple(KnobRung(r.value, r.recall) for r in rungs)
                              for name, rungs in tune.ladder.items()},
                      boost=boost)


def reference_over_port(idx):
    """The reference's MonaVec over the port's segments (its coarse codes
    derived by the reference) and autotune result, so that a search
    comparison does not hinge on a boundary flip of an encode."""
    import jax.numpy as jnp
    from repro.core import BruteForceIndex, MonaVec
    from repro.core import quantize as rqz
    from repro.core import segments as rseg
    from repro.core.standardize import GlobalStd

    def ref_enc(e):
        std = None if e.std is None else GlobalStd(e.std.mean, e.std.inv_std)
        return rqz.Encoded(packed=jnp.asarray(e.packed.cpu().numpy()),
                           qnorms=jnp.asarray(e.qnorms.cpu().numpy()), seed=e.seed,
                           metric=e.metric, bits=e.bits, dim=e.dim, dim_pad=e.dim_pad,
                           n4_dims=e.n4_dims, std=std, perm=e.perm)

    (e0, ids0, t0), *extras = _segments_of(idx)
    mut = rseg.SegmentedState(
        base_tombs=t0.copy(), next_ordinal=idx.mut.next_ordinal,
        extras=[rseg.Segment(enc=ref_enc(e), ids=ids, tombs=t.copy()) for e, ids, t in extras])
    ref = MonaVec(BruteForceIndex(enc=ref_enc(e0), ids=ids0), mut=mut,
                  tuned=reference_tune(idx.tuned))
    return ref if e0.coarse is None else ref.enable_coarse(e0.coarse)


def segmented_tolerance(idx, queries: np.ndarray) -> np.ndarray:
    """[b, n_total] score bounds of the port's index, segment by segment."""
    cols = []
    for enc, _, _ in _segments_of(idx):
        q_rot = tqz.encode_query(torch.from_numpy(queries), enc).numpy()
        cols.append(adjusted_tolerance(dot_tolerance(q_rot, enc.packed.numpy(), enc.bits,
                                                     enc.n4_dims),
                                       enc.qnorms.numpy(), enc.metric))
    return np.concatenate(cols, axis=1)


def reference_full_scores(ref, queries: np.ndarray) -> np.ndarray:
    """The reference's adjusted scores [b, n_total] of every row, unmasked."""
    import jax.numpy as jnp
    from repro.core import quantize as rqz
    from repro.kernels import ops as rops

    cols = [np.asarray(rops.score_packed(rqz.encode_query(jnp.asarray(queries), enc), enc,
                                         use_kernel=False))
            for enc, _, _ in _segments_of(ref)]
    return np.concatenate(cols, axis=1)


def assert_segmented_search_matches(idx, ref, queries: np.ndarray, k: int, **kw):
    """The port's search of ``idx`` against the reference's of ``ref`` (the
    same codes): ids equal except ties within the tolerance, scores within
    it, sentinels in the same slots."""
    import jax.numpy as jnp

    got = idx.search(queries, k, **kw)
    want = ref.search(jnp.asarray(queries), k, **kw)
    assert np.array_equal(got[1] == SENTINEL, want[1] == SENTINEL)
    assert_search_matches(got, want, reference_full_scores(ref, queries), idx.ids,
                          segmented_tolerance(idx, queries))
    return got, want


SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
