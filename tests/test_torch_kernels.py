"""The port's kernel modules on the CPU: each wrapper's plain version against
the reference's plain version and its Pallas kernel in interpret mode.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds them
against these same plain versions there.  Here the wrappers are checked for
what they refuse before any build, and the dispatchers for taking the plain
version on a CPU tensor without counting a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as qz, scoring
from repro.kernels import ops, ref
from repro_torch.core import quantize as tqz
from repro_torch.core import rhdh as trhdh
from repro_torch.core import scoring as tscoring
from repro_torch.core.convert import encoded_from_arrays
from repro_torch.kernels import cuda_build as tcuda_build
from repro_torch.kernels import hadamard as thadamard
from repro_torch.kernels import nibble_dot as tnibble
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.torch_harness import adjusted_tolerance, dot_tolerance


@pytest.mark.parametrize("n,d,b", [(128, 128, 1), (300, 256, 3), (45, 64, 9), (1000, 256, 5)])
def test_plain_scan_matches_reference_and_interpret_kernel(n, d, b):
    rng = np.random.RandomState(1)
    packed = rng.randint(0, 256, size=(n, d // 2)).astype(np.uint8)
    q = rng.randn(b, d).astype(np.float32)
    got = tops.nibble_score_raw(torch.from_numpy(packed), torch.from_numpy(q)).numpy()
    tol = dot_tolerance(q, packed)
    want_ref = np.asarray(ref.nibble_dot_ref(jnp.asarray(packed), jnp.asarray(q)))
    want_kernel = np.asarray(ops.nibble_score_raw(jnp.asarray(packed), jnp.asarray(q),
                                                  use_kernel=True, interpret=True))
    assert got.shape == (b, n)
    assert np.all(np.abs(got - want_ref) <= tol)
    assert np.all(np.abs(got - want_kernel) <= tol)


def test_every_code_value_dequantizes():
    rng = np.random.RandomState(2)
    codes = np.tile(np.arange(16, dtype=np.uint8), 8)[None].repeat(40, 0)
    packed = tqz.pack_4bit(torch.from_numpy(codes))
    q = rng.randn(3, 128).astype(np.float32)
    got = tref.nibble_dot_ref(packed, torch.from_numpy(q)).numpy()
    deq = tqz.decode(encoded_from_arrays(packed.numpy(), np.ones(40, np.float32), seed=0,
                                         metric="dot", bits=4, dim=128, dim_pad=128,
                                         device="cpu")).numpy()
    np.testing.assert_allclose(got, q.astype(np.float64) @ deq.T.astype(np.float64),
                               rtol=1e-5, atol=1e-5)


def test_plain_scan_rows_do_not_depend_on_batch():
    rng = np.random.RandomState(3)
    packed = torch.from_numpy(rng.randint(0, 256, size=(500, 64)).astype(np.uint8))
    q = torch.from_numpy(rng.randn(13, 128).astype(np.float32))
    full = tref.nibble_dot_ref(packed, q)
    for lo, hi in [(0, 1), (3, 10), (12, 13)]:
        assert torch.equal(tref.nibble_dot_ref(packed, q[lo:hi]), full[lo:hi])


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_score_packed_matches_reference(metric):
    rng = np.random.RandomState(4)
    corpus = rng.randn(300, 96).astype(np.float32)
    enc = qz.encode(jnp.asarray(corpus), metric=metric, seed=11)
    q_rot = np.array(qz.encode_query(jnp.asarray(rng.randn(6, 96).astype(np.float32)), enc))
    tenc = encoded_from_arrays(np.asarray(enc.packed), np.asarray(enc.qnorms), seed=11,
                               metric=metric, bits=4, dim=96, dim_pad=128, device="cpu")
    got = tops.score_packed(torch.from_numpy(q_rot), tenc).numpy()
    want = np.asarray(scoring.score_packed_ref(jnp.asarray(q_rot), enc))
    tol = adjusted_tolerance(dot_tolerance(q_rot, np.asarray(enc.packed)),
                             np.asarray(enc.qnorms), metric)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_adjust_scores_bit_equal(metric):
    rng = np.random.RandomState(5)
    raw = rng.randn(4, 50).astype(np.float32) * 30
    qn = (rng.rand(50).astype(np.float32) + 0.1) * 10
    got = tscoring.adjust_scores(torch.from_numpy(raw), torch.from_numpy(qn), metric).numpy()
    want = np.asarray(scoring.adjust_scores(jnp.asarray(raw), jnp.asarray(qn), metric))
    np.testing.assert_array_equal(got, want)


def test_signed_fwht_cpu_dispatch_is_the_plain_version_and_uncounted():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(10, 200).astype(np.float32))
    signs = trhdh.rademacher_signs(5, 256)
    before = thadamard.fwht_cuda.launches
    got = thadamard.signed_fwht(x, signs, 256)
    assert torch.equal(got, thadamard.signed_fwht_plain(x, signs, 256))
    assert torch.equal(got, trhdh.fwht(torch.nn.functional.pad(x, (0, 56)) * signs))
    assert thadamard.fwht_cuda.launches == before


def test_scan_cpu_dispatch_is_the_plain_version_and_uncounted():
    rng = np.random.RandomState(7)
    packed = torch.from_numpy(rng.randint(0, 256, size=(70, 32)).astype(np.uint8))
    q = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    before = tnibble.nibble_dot_cuda.launches
    assert torch.equal(tops.nibble_score_raw(packed, q), tref.nibble_dot_ref(packed, q))
    assert tnibble.nibble_dot_cuda.launches == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "d_pad", "signs", "cpu_at_d_pad_65536"])
def test_fwht_cuda_refuses_before_building(bad, monkeypatch):
    loads = []
    monkeypatch.setattr(tcuda_build, "load", loads.append)
    x, signs, d_pad = torch.zeros(4, 100), torch.ones(128), 128
    match = None
    if bad == "dtype":
        x = x.double()
    elif bad == "d_pad":
        d_pad = 96
    elif bad == "signs":
        signs = torch.ones(64)
    elif bad == "cpu_at_d_pad_65536":
        # Past one block's 32768: the shape checks pass it, so only the
        # CPU tensor is refused.
        x, signs, d_pad, match = torch.zeros(2, 40000), torch.ones(65536), 65536, "CUDA device"
    with pytest.raises(ValueError, match=match):
        thadamard.fwht_cuda(x, signs, d_pad)
    assert loads == []


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape"])
def test_nibble_dot_cuda_refuses_before_building(bad):
    packed, q = torch.zeros(10, 64, dtype=torch.uint8), torch.zeros(3, 128)
    if bad == "dtype":
        packed = packed.to(torch.int8)
    elif bad == "shape":
        q = torch.zeros(3, 64)
    with pytest.raises(ValueError):
        tnibble.nibble_dot_cuda(packed, q)


@pytest.mark.parametrize("b,n,d", [(1, 1, 48), (7, 129, 48), (65, 300, 1024)])
@pytest.mark.parametrize("fn", ["nibble_dot_cuda", "crumb_dot_cuda"])
def test_scan_wrappers_refuse_ragged_cpu_shapes_without_building(fn, b, n, d, monkeypatch):
    # Ragged b and n (a partial 64 x 128 tile) and d' not a whole 32-dim
    # step: the wrapper raises for CPU tensors before it loads any library.
    loads = []
    monkeypatch.setattr(tcuda_build, "load", loads.append)
    wrapper = getattr(tnibble, fn)
    per = tnibble.CODES_PER_BYTE[4 if fn == "nibble_dot_cuda" else 2]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(torch.zeros(n, d // per, dtype=torch.uint8), torch.zeros(b, d))
    assert loads == [] and wrapper.launches == before


def test_other_bit_widths_raise():
    with pytest.raises(ValueError, match="unsupported bits=5"):
        tops.score_raw(torch.zeros(2, 4, dtype=torch.uint8), torch.zeros(1, 16), bits=5)


def test_stable_topk_zero_row_takes_lowest_indices():
    vals, idx = tscoring.topk(torch.zeros(1, 4096), 8)
    assert idx.tolist() == [list(range(8))]
    assert vals.tolist() == [[0.0] * 8]


@pytest.mark.parametrize("k", [1, 5, 40])
def test_stable_topk_matches_lax_top_k_on_ties(k):
    rng = np.random.RandomState(8)
    scores = rng.randint(-3, 4, size=(6, 40)).astype(np.float32)
    vals, idx = tscoring.topk(torch.from_numpy(scores), k)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
