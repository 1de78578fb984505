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
