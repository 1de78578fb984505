"""The plain reference against hand-made cases, and the program's codes on
the CPU against the reference's judge.

    python -m pytest -q -p no:cacheprovider portbench/checks/check_reference.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import stand_in  # noqa: F401  (puts the checkout on the path)
from portbench.reference import encode as enc
from portbench.reference import search
from portbench.reference import signs


def test_signs_are_the_programs_stream():
    from repro_torch.core import rhdh

    for seed in (0, 0x6D6F6E61, 2**33 + 5):
        for d in (8, 1024):
            assert np.array_equal(signs.signs(seed, d),
                                  rhdh.rademacher_signs_np(seed, d, partitionable=True))


def test_rotation_of_a_unit_vector_is_a_signed_hadamard_column():
    d = 16
    s = torch.from_numpy(signs.signs(7, d))
    h = enc._hadamard_on(d, torch.device("cpu"))
    for i in (0, 5, 15):
        e = torch.zeros(1, d)
        e[0, i] = 1.0
        assert torch.equal(enc.rotate(e, 7)[0], s[i] * h[:, i])


def test_rotation_pads_and_matches_the_matrix_product():
    x = torch.randint(-8, 8, (5, 12)).float()     # small integers: every sum exact
    d_pad = 16
    s = torch.from_numpy(signs.signs(3, d_pad))
    want = torch.nn.functional.pad(x * s[:12], (0, 4)) @ enc._hadamard_on(d_pad,
                                                                         torch.device("cpu"))
    assert torch.equal(enc.rotate(x, 3), want)
    assert torch.equal(enc.rotate(x, 3, precision="tf32"), want)


def test_quantize_counts_boundaries_at_or_below():
    b = torch.from_numpy(enc.BOUNDARIES_4BIT)
    below = torch.nextafter(b, torch.tensor(-np.inf))
    assert torch.equal(enc.quantize(b[None]), torch.arange(1, 16, dtype=torch.uint8)[None])
    assert torch.equal(enc.quantize(below[None]), torch.arange(0, 15, dtype=torch.uint8)[None])
    assert enc.quantize(torch.tensor([[-9.0, 9.0, -0.0]])).tolist() == [[0, 15, 8]]


def test_pack_layout_and_round_trip():
    codes = torch.tensor([[1, 2, 15, 0]], dtype=torch.uint8)
    assert enc.pack(codes).tolist() == [[0x21, 0x0F]]
    rng = torch.Generator().manual_seed(0)
    c = torch.randint(0, 16, (7, 64), generator=rng, dtype=torch.uint8)
    assert torch.equal(enc.unpack(enc.pack(c)), c)


def test_sign_codes_are_little_endian_bits_of_code_ge_8():
    rng = torch.Generator().manual_seed(1)
    c = torch.randint(0, 16, (5, 64), generator=rng, dtype=torch.uint8)
    want = np.packbits((c.numpy() >= 8), axis=1, bitorder="little")
    assert np.array_equal(enc.sign_codes(enc.pack(c)).numpy(), want)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, 1.0 + 2.0**-12, -3.0])
    assert enc.to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2.0**-9, 1.0, -3.0]


def test_norms_do_not_depend_on_the_other_rows():
    rng = torch.Generator().manual_seed(2)
    x = torch.randn(200, 768, generator=rng)
    whole = enc.unit_rows(x)
    for lo, hi in ((0, 1), (3, 70), (130, 200)):
        assert torch.equal(enc.unit_rows(x[lo:hi]), whole[lo:hi])


def _rows_near(values: list, d: int = 16) -> torch.Tensor:
    """Unit rows whose f64 rotation (seed 0) starts with ``values`` and
    carries the rest of a unit norm's worth of energy in one more value."""
    s = torch.from_numpy(signs.signs(0, d)).double()
    h = enc._hadamard_on(d, torch.device("cpu")).double()
    rows = []
    for v in values:
        y = torch.zeros(d, dtype=torch.float64)
        y[0], y[1] = v, (d - v * v) ** 0.5
        rows.append((h @ y) / d * s)     # H is its own inverse up to d
    return torch.stack(rows)


def test_judge_accepts_a_neighbour_code_only_at_its_boundary():
    b = float(enc.BOUNDARIES_4BIT[9])
    x = _rows_near([b + enc.TOL / 4, b - enc.TOL / 4, b + 4 * enc.TOL, 0.6])
    ref = enc.encode(x, 0)
    rot = enc.rotate(enc.unit_rows(x), 0)
    assert torch.allclose(rot[:, 0], x.new_tensor([b + enc.TOL / 4, b - enc.TOL / 4,
                                                   b + 4 * enc.TOL, 0.6]).double(),
                          atol=1e-12)
    codes = enc.unpack(ref)
    assert codes[:, 0].tolist() == [10, 9, 10, 10]
    flipped = codes.clone()
    flipped[:, 0] = torch.tensor([9, 10, 9, 9], dtype=torch.uint8)
    differ, resolved = enc.judge(x, 0, enc.pack(flipped))
    # The first two lie within TOL of the boundary: the program's code is
    # taken; the last two lie farther off and each counts as one byte.
    assert differ == 2
    assert enc.unpack(resolved)[:, 0].tolist() == [9, 10, 10, 10]
    two_off = codes.clone()
    two_off[0, 0] = 8
    assert enc.judge(x, 0, enc.pack(two_off))[0] == 1
    differ, same = enc.judge(x, 0, ref)
    assert differ == 0 and torch.equal(same, ref)


def _brute_scores(q_rot: torch.Tensor, packed: torch.Tensor) -> np.ndarray:
    deq = enc.CENTROIDS_4BIT.astype(np.float64)[enc.unpack(packed).numpy()]
    raw = q_rot.double().numpy() @ deq.T
    return raw / np.linalg.norm(deq, axis=1)


def test_full_topk_against_brute_force_with_ties_to_the_lower_row():
    rng = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 16, (300, 32), generator=rng, dtype=torch.uint8)
    codes[200] = codes[17]                       # an exact tie: row 17 ranks first
    packed = enc.pack(codes)
    q = torch.randn(6, 32, generator=rng)
    q[0] = torch.from_numpy(enc.CENTROIDS_4BIT)[codes[17].long()]
    v, r = search.topk_full(q, packed, 5)
    s = _brute_scores(q, packed)
    order = np.argsort(-s, axis=1, kind="stable")[:, :5]
    assert np.array_equal(r.numpy(), order)
    assert np.allclose(v.numpy(), np.take_along_axis(s, order, 1), rtol=1e-12)
    assert r[0, 0] == 17 and 200 in r[0].tolist()


def test_survivors_are_least_hamming_with_ties_to_the_lower_row():
    rng = torch.Generator().manual_seed(4)
    codes = torch.randint(0, 16, (500, 64), generator=rng, dtype=torch.uint8)
    packed = enc.pack(codes)
    q = torch.randn(3, 64, generator=rng)
    cand = search.survivors(q, search.sign_planes(packed), 40)
    qb = (q.numpy() >= 0)
    cb = (codes.numpy() >= 8)
    ham = (qb[:, None, :] != cb[None, :, :]).sum(-1)
    want = np.argsort(ham, axis=1, kind="stable")[:, :40]
    assert np.array_equal(cand.numpy(), want)


def test_scores_at_equal_the_brute_force():
    rng = torch.Generator().manual_seed(5)
    packed = enc.pack(torch.randint(0, 16, (50, 32), generator=rng, dtype=torch.uint8))
    q = torch.randn(4, 32, generator=rng)
    rows = torch.randint(0, 50, (4, 3), generator=rng)
    want = np.take_along_axis(_brute_scores(q, packed), rows.numpy(), 1)
    assert np.allclose(search.scores_at(q, packed, rows).numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("dim", [768, 1024])
def test_programs_codes_pass_the_judge(dim):
    from repro_torch import MonaVec

    rng = torch.Generator().manual_seed(6)
    x = torch.randn(300, dim, generator=rng) * 0.1 + torch.randn(1, dim, generator=rng)
    idx = MonaVec.build(x, metric="cosine", seed=0x6D6F6E61, device="cpu")
    differ, ref = enc.judge(x, 0x6D6F6E61, idx.backend.enc.packed)
    assert differ == 0
    assert torch.allclose(idx.backend.enc.qnorms.double(), enc.norms64(ref), rtol=1e-6)
    assert 0 < int((enc.encode(x, 0x6D6F6E61, precision="tf32") != ref).sum())


def test_open_sign_bits_take_the_choice_that_fits_the_returned_rows():
    from portbench.harness import judge

    rng = torch.Generator().manual_seed(7)
    packed = enc.pack(torch.randint(0, 16, (400, 64), generator=rng, dtype=torch.uint8))
    planes = search.sign_planes(packed)
    q = torch.randn(64, generator=rng, dtype=torch.float64)
    q[5] = 0.0
    for sign in (1.0, -1.0):
        clear = q.clone()
        clear[5] = sign * 1e-3       # the sign bit a program chose, read clearly
        want = search.survivors(clear[None], planes, 30)[0]
        top, rows = search.topk_among(q[None], packed, want[None], 10)
        got = judge._closest_survivors(q, planes, packed, 30, rows[0], top[0])
        assert set(got.tolist()) == set(want.tolist())
