"""The port's segmented lifecycle (add / delete / compact, format v8 and v10
with segments) on the CPU against the reference.

The same numpy inputs go through ``repro`` and through ``repro_torch`` on the
CPU:

* segment seeds are Python integers and must be equal exactly;
* an ``add`` encodes in each package, so its codes may differ only by a
  one-level flip of a value on a Lloyd-Max boundary (``code_flip_rows``);
* searches run both packages over one set of segments (the port's through
  ``reference_over_port``, or the reference's through ``convert``), so ids
  may differ only where scores tie within the f32 rule, and sentinel slots
  are equal;
* files cross between the packages both ways, load -> save gives the same
  bytes, and replaying one op sequence gives the same file.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MonaVec as RefMonaVec
from repro.core import mvec_format as rfmt
from repro.core import quantize as rqz
from repro.core import rhdh as rrhdh
from repro.core import segments as rseg
from repro.core import standardize as rstd
from repro.core.allowlist import Allowlist as RefAllowlist
from repro_torch import MonaVec
from repro_torch.core import mvec_format as fmt
from repro_torch.core import segments as seg
from repro_torch.core.allowlist import NEG, Allowlist
from repro_torch.core.segments import SENTINEL_ID
from tests.torch_harness import (assert_segmented_search_matches, code_flip_rows,
                                 port_over_reference, port_stream, reference_over_port,
                                 reference_stream)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DIM = 40
MODES = ["bits4", "bits2", "mixed", "v7"]


@pytest.fixture(autouse=True)
def _follow_reference_stream():
    with port_stream(reference_stream()):
        yield


def _vecs(rng, n, dim=DIM):
    return (rng.randn(n, dim) * 2 + 0.3).astype(np.float32)


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _build_both(mode: str, x: np.ndarray, metric: str = "cosine", coarse=None):
    """The reference's index and the port's over the same vectors, each
    encoded by its own package (for v7 under the reference's permutation)."""
    std = RefMonaVec.fit(x) if metric == "l2" else None
    tstd = MonaVec.fit(x) if metric == "l2" else None
    kw = dict(metric=metric, seed=23, coarse=coarse)
    if mode in ("bits4", "bits2"):
        bits = int(mode[-1])
        return (RefMonaVec.build(jnp.asarray(x), bits=bits, std=std, **kw),
                MonaVec.build(x, bits=bits, std=tstd, device="cpu", **kw))
    if mode == "mixed":
        return (RefMonaVec.build(jnp.asarray(x), avg_bits=3.0, std=std, **kw),
                MonaVec.build(x, avg_bits=3.0, std=tstd, device="cpu", **kw))
    from repro.core import BruteForceIndex as RefBF
    from repro_torch.core import quantize as tqz
    from repro_torch.core.bruteforce import BruteForceIndex

    rot = rrhdh.rhdh_apply(rstd.prepare(jnp.asarray(x[:32]), metric, std), 23,
                           normalized=False)
    perm = rqz.variance_permutation(rot)
    ids = np.arange(len(x), dtype=np.uint64)
    ref = RefMonaVec(RefBF(enc=rqz.encode_mixed(jnp.asarray(x), metric=metric, seed=23,
                                                avg_bits=3.0, std=std, perm=perm), ids=ids))
    port = MonaVec(BruteForceIndex(enc=tqz.encode_mixed(torch.from_numpy(x), metric=metric,
                                                        seed=23, avg_bits=3.0, std=tstd,
                                                        perm=perm), ids=ids))
    if coarse is not None:
        ref.enable_coarse(coarse)
        port.enable_coarse(coarse)
    return ref, port


def _assert_codes_match(port_enc, ref_enc, vectors):
    """The port's codes of ``vectors`` against the reference's, up to
    boundary flips (in the packed dim order)."""
    std = None if ref_enc.std is None else ref_enc.std
    prepared = rstd.prepare(jnp.asarray(vectors), ref_enc.metric, std)
    rot = np.asarray(rrhdh.rhdh_apply(prepared, ref_enc.seed, normalized=False))
    if ref_enc.perm is not None:
        rot = rot[:, ref_enc.perm]
    code_flip_rows(port_enc.packed.numpy(), np.asarray(ref_enc.packed), rot,
                   np.asarray(prepared), ref_enc.bits, ref_enc.n4_dims)


# ---------------------------------------------------------------------------
# Seeds and encodes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", [0, 1, 0x6D6F6E61, 2 ** 63, 2 ** 64 - 1, 2 ** 64 + 5])
def test_derive_segment_seed_equals_reference(root):
    for ordinal in (0, 1, 2, 3, 17, 1000, 2 ** 32 + 7, 2 ** 40):
        got = seg.derive_segment_seed(root, ordinal)
        assert got == rseg.derive_segment_seed(root, ordinal)
        assert 0 <= got < 2 ** 64
    assert seg.derive_segment_seed(root, 0) == root & (2 ** 64 - 1)
    assert len({seg.derive_segment_seed(root, o) for o in range(1, 200)}) == 199


@pytest.mark.parametrize("mode", MODES)
def test_add_encodes_like_the_reference(mode):
    """Two adds in each package: the same seeds and ids, the same layout,
    codes equal up to boundary flips, norms within rtol 1e-6, and the
    coarse codes of each segment derived as the reference derives them."""
    rng = np.random.RandomState(3)
    x = _vecs(rng, 120)
    ref, port = _build_both(mode, x, coarse="crumb")
    for n_new in (17, 40):
        batch = _vecs(rng, n_new)
        want = ref.add(jnp.asarray(batch))
        got = port.add(batch)
        np.testing.assert_array_equal(got, want)
        r, p = ref.mut.extras[-1].enc, port.mut.extras[-1].enc
        assert (p.seed, p.bits, p.n4_dims, p.coarse) == (r.seed, r.bits, r.n4_dims, r.coarse)
        assert (p.perm is None) == (r.perm is None)
        if r.perm is not None:
            np.testing.assert_array_equal(p.perm, r.perm)
        _assert_codes_match(p, r, batch)
        np.testing.assert_allclose(p.qnorms.numpy(), np.asarray(r.qnorms), rtol=1e-6)
    assert port.mut.next_ordinal == ref.mut.next_ordinal == 3
    assert port.n_total == ref.n_total == 177
    np.testing.assert_array_equal(port.ids, ref.ids)


# ---------------------------------------------------------------------------
# Search over segments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("rm", [None, 3])
def test_interleaved_add_delete_search_match_reference(metric, rm):
    """add / delete / search interleaved in the port; after every op the
    port's search equals the reference's over the port's segments, full scan
    and cascade, static and mutated."""
    rng = np.random.RandomState(7)
    x = _vecs(rng, 150)
    _, port = _build_both("bits4", x, metric=metric, coarse="sign")
    q = _vecs(rng, 6)
    kw = {"rescore_mult": rm}
    ops = [("search",), ("add", 30), ("search",), ("delete", 0), ("search",),
           ("add", 25), ("delete", 1), ("search",), ("delete", 2), ("search",)]
    for op in ops:
        if op[0] == "add":
            port.add(_vecs(rng, op[1]))
        elif op[0] == "delete":
            seg_ids = port.ids[port.backend.enc.n:] if op[1] else port.backend.ids
            assert port.delete(seg_ids[op[1]::4]) > 0
        assert_segmented_search_matches(port, reference_over_port(port), q, 10, **kw)
    assert port.n_live < port.n_total


@pytest.mark.parametrize("mode", MODES)
def test_reference_mutated_index_converts_and_searches_alike(mode):
    """The reference's own mutated index (its adds, its tombstones) carried
    over with ``convert.segmented_from_arrays``: the same state, and the
    same results under both packages' searches."""
    rng = np.random.RandomState(11)
    x = _vecs(rng, 130)
    ref, _ = _build_both(mode, x, coarse="crumb")
    ref.add(jnp.asarray(_vecs(rng, 30)))
    ref.delete(ref.ids[::5])
    ref.add(jnp.asarray(_vecs(rng, 20)))
    ref.delete([131, 133, 170])
    port = port_over_reference(ref)
    assert (port.n_total, port.n_live) == (ref.n_total, ref.n_live)
    assert port.mut.next_ordinal == ref.mut.next_ordinal
    np.testing.assert_array_equal(port.ids, ref.ids)
    for s_p, s_r in zip(port.mut.extras, ref.mut.extras):
        assert s_p.enc.seed == s_r.enc.seed
        np.testing.assert_array_equal(s_p.tombs, s_r.tombs)
        np.testing.assert_array_equal(s_p.enc.ccodes.numpy(), np.asarray(s_r.enc.ccodes))
    q = _vecs(rng, 5)
    for rm in (None, 2):
        assert_segmented_search_matches(port, ref, q, 12, rescore_mult=rm)


@pytest.mark.parametrize("rm", [None, 2])
def test_deleted_rows_never_returned_and_underflow_pads(rm):
    rng = np.random.RandomState(13)
    x = _vecs(rng, 40)
    _, port = _build_both("bits4", x, coarse="sign")
    port.add(_vecs(rng, 10))
    dead = list(range(0, 50, 3))
    assert port.delete(dead) == len(dead)
    assert port.delete(dead) == 0                      # already dead
    q = np.concatenate([x[:6], _vecs(rng, 2)])
    _, ids = port.search(q, 10, rescore_mult=rm)
    assert not set(ids.ravel().tolist()) & set(dead)
    # k above the live count (the cascade's budget then covers every row)
    s, ids = port.search(q, 40, rescore_mult=rm)
    assert port.n_live == 33
    assert (ids[:, 33:] == SENTINEL_ID).all() and (s[:, 33:] == NEG).all()
    assert (ids[:, :33] != SENTINEL_ID).all()
    assert_segmented_search_matches(port, reference_over_port(port), q, 40, rescore_mult=rm)


def test_allowlist_over_every_segment_matches_reference():
    rng = np.random.RandomState(17)
    _, port = _build_both("bits4", _vecs(rng, 60))
    port.add(_vecs(rng, 20))
    port.delete([1, 2, 61])
    allowed = [0, 1, 5, 9, 33, 60, 61, 62, 70, 79]
    allow = Allowlist.from_ids(allowed, port.ids)
    ref = reference_over_port(port)
    q = _vecs(rng, 4)
    got = port.search(q, 10, allow=allow)
    want = ref.search(jnp.asarray(q), 10, allow=RefAllowlist(mask=allow.mask,
                                                             n_allowed=allow.n_allowed))
    np.testing.assert_array_equal(np.sort(got[1], axis=1), np.sort(want[1], axis=1))
    live_allowed = set(allowed) - {1, 2, 61}
    assert set(got[1].ravel().tolist()) - {int(SENTINEL_ID)} == live_allowed
    with pytest.raises(ValueError, match="build it from MonaVec.ids"):
        port.search(q, 3, allow=Allowlist.from_ids([0], port.backend.ids))


# ---------------------------------------------------------------------------
# Compaction.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_reconstruct_vectors_matches_reference(metric):
    rng = np.random.RandomState(19)
    x = _vecs(rng, 80)
    ref, _ = _build_both("mixed", x, metric=metric)
    port = port_over_reference(ref)
    got = seg.reconstruct_vectors(port.backend.enc).numpy()
    want = np.asarray(rseg.reconstruct_vectors(ref.backend.enc))
    enc = ref.backend.enc
    deq = np.asarray(rqz.decode(enc))
    # Both invert one f32 transform in another summation order: a per-row
    # bound in |deq|_1 / d', scaled back through the L2 standardization.
    scale = 1.0 if enc.std is None else 1.0 / enc.std.inv_std
    tol = (1e-5 * np.abs(deq).sum(axis=1, keepdims=True) / enc.dim_pad * scale
           + 1e-6 * (1.0 + (0.0 if enc.std is None else abs(enc.std.mean))))
    assert got.shape == want.shape == x.shape
    assert np.all(np.abs(got - want) <= tol)
    rows = np.array([3, 0, 79, 41])
    np.testing.assert_array_equal(seg.reconstruct_rows(port.backend.enc, rows).numpy(),
                                  got[rows])


@pytest.mark.parametrize("mode", MODES)
def test_compact_matches_reference(mode):
    """Both packages compact the same segments: the same ids and count,
    codes equal up to boundary flips of the reference's reconstruction, and
    the compacted indexes search alike."""
    rng = np.random.RandomState(23)
    x = _vecs(rng, 100)
    ref, _ = _build_both(mode, x, coarse="sign")
    ref.add(jnp.asarray(_vecs(rng, 30)))
    ref.delete(ref.ids[::6])
    port = port_over_reference(ref)
    live_vecs = np.concatenate([np.asarray(rseg.reconstruct_vectors(enc))[live] for enc, live in
                                zip([ref.backend.enc] + [s.enc for s in ref.mut.extras],
                                    ref._live_masks())])
    assert port.compact() == ref.compact() == 22
    assert port.mut.is_static and port.n_total == ref.n_total == 108
    np.testing.assert_array_equal(port.ids, ref.ids)
    _assert_codes_match(port.backend.enc, ref.backend.enc, live_vecs)
    assert port.backend.enc.coarse == "sign"
    assert port.compact() == 0                              # nothing left to reclaim
    q = _vecs(rng, 5)
    for rm in (None, 3):
        assert_segmented_search_matches(port, reference_over_port(port), q, 10,
                                        rescore_mult=rm)


def test_compact_all_dead_raises_and_empty_add_is_noop():
    rng = np.random.RandomState(29)
    _, port = _build_both("bits4", _vecs(rng, 8))
    assert port.add(np.zeros((0, DIM), np.float32)).shape == (0,)
    assert port.mut.is_static
    port.delete(range(8))
    with pytest.raises(ValueError, match="no live rows"):
        port.compact()


@pytest.mark.parametrize("bad", ["dim", "dup_batch", "live_clash", "len"])
def test_add_guards_raise_like_reference(bad):
    rng = np.random.RandomState(31)
    x = _vecs(rng, 12)
    ref, port = _build_both("bits4", x)
    vecs, ids = _vecs(rng, 3), [100, 101, 102]
    if bad == "dim":
        vecs = _vecs(rng, 3, DIM + 1)
    elif bad == "dup_batch":
        ids = [100, 100, 101]
    elif bad == "live_clash":
        ids = [5, 100, 101]
    else:
        ids = [100, 101]
    with pytest.raises(ValueError) as want:
        ref.add(jnp.asarray(vecs), ids=ids)
    with pytest.raises(ValueError) as got:
        port.add(vecs, ids=ids)
    assert str(got.value) == str(want.value)
    port.delete([5])
    if bad == "live_clash":     # a tombstoned id may come back
        assert port.add(_vecs(rng, 3), ids=ids).tolist() == ids


# ---------------------------------------------------------------------------
# Files.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coarse", [None, "crumb"])
@pytest.mark.parametrize("mode", ["bits4", "v7"])
def test_port_segmented_file_loads_in_reference(mode, coarse, tmp_path):
    rng = np.random.RandomState(37)
    _, port = _build_both(mode, _vecs(rng, 90), coarse=coarse)
    port.add(_vecs(rng, 25))
    port.delete([0, 7, 95])
    path = str(tmp_path / "port.mvec")
    port.save(path)
    assert open(path, "rb").read()[4] == (10 if coarse else 8)
    ref = RefMonaVec.load(path)
    assert (ref.n_total, ref.n_live, ref.mut.next_ordinal) == (115, 112, 2)
    q = _vecs(rng, 5)
    for rm in ((None, 2) if coarse else (None,)):
        assert_segmented_search_matches(port, ref, q, 10, rescore_mult=rm)
    again = str(tmp_path / "again.mvec")
    ref.save(again)
    assert _sha(again) == _sha(path)


@pytest.mark.parametrize("coarse", [None, "sign"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_reference_segmented_file_loads_in_port_and_saves_its_bytes(metric, coarse, tmp_path):
    rng = np.random.RandomState(41)
    x = _vecs(rng, 70)
    ref, _ = _build_both("bits4", x, metric=metric, coarse=coarse)
    ref.add(jnp.asarray(_vecs(rng, 12)))
    ref.add(jnp.asarray(_vecs(rng, 9)))
    ref.delete([3, 71, 80])
    path = str(tmp_path / "ref.mvec")
    ref.save(path)
    port = MonaVec.load(path, device="cpu")
    assert (port.n_total, port.n_live, port.mut.next_ordinal) == (91, 88, 3)
    again = str(tmp_path / "again.mvec")
    port.save(again)
    assert _sha(again) == _sha(path)
    q = _vecs(rng, 4)
    for rm in ((None, 2) if coarse else (None,)):
        assert_segmented_search_matches(port, RefMonaVec.load(path), q, 10, rescore_mult=rm)
    # save -> load -> search in the port gives the same bytes
    a = port.search(q, 10)
    b = MonaVec.load(again, device="cpu").search(q, 10)
    assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


def test_golden_v8_round_trips_at_the_format_level(tmp_path):
    """The v8 fixture (an IVF index with an extra segment) loads as data and
    saves its own bytes; its IVF blob unpacks as the reference's does."""
    src = os.path.join(GOLDEN, "v8_segmented_ivf.mvec")
    f = fmt.load(src)
    r = rfmt.load(src)
    assert f.index_type == fmt.INDEX_IVF and len(f.extras) == len(r.extras) >= 1
    out = str(tmp_path / "v8.mvec")
    fmt.save(out, f)
    assert _sha(out) == _sha(src)
    for got, want in zip(fmt.unpack_ivf_blob(f.index_data), rfmt.unpack_ivf_blob(r.index_data)):
        np.testing.assert_array_equal(got, want)
    assert fmt.pack_ivf_blob(*fmt.unpack_ivf_blob(f.index_data)) == f.index_data
    for t_got, t_want in zip(f.tombs, r.tombs):
        np.testing.assert_array_equal(t_got, t_want)


@pytest.mark.parametrize("what", ["segment", "tombstones"])
def test_truncated_segment_table_raises(what, tmp_path):
    rng = np.random.RandomState(43)
    _, port = _build_both("bits4", _vecs(rng, 20))
    port.add(_vecs(rng, 4))
    path = str(tmp_path / "s.mvec")
    port.save(path)
    data = open(path, "rb").read()
    cut = {"segment": 60, "tombstones": 3}[what]
    bad = tmp_path / "cut.mvec"
    bad.write_bytes(data[:-cut])
    with pytest.raises(ValueError, match="truncated"):
        MonaVec.load(str(bad), device="cpu")


# ---------------------------------------------------------------------------
# Replay.
# ---------------------------------------------------------------------------

def _replay(mode: str, coarse, tmp_path, tag: str) -> list:
    rng = np.random.RandomState(47)
    x = _vecs(rng, 64)
    _, port = _build_both(mode, x, coarse=coarse)
    digests = []
    for i, op in enumerate(["add", "delete", "add", "save", "compact", "add", "save"]):
        if op == "add":
            port.add(_vecs(rng, 9))
        elif op == "delete":
            port.delete(port.ids[::4])
        elif op == "compact":
            port.compact()
        else:
            path = str(tmp_path / f"{tag}-{i}.mvec")
            port.save(path)
            digests.append(_sha(path))
    return digests


@pytest.mark.parametrize("mode,coarse", [("bits4", None), ("mixed", "crumb"), ("v7", None)])
def test_replay_serializes_byte_identically(mode, coarse, tmp_path):
    a = _replay(mode, coarse, tmp_path, "a")
    b = _replay(mode, coarse, tmp_path, "b")
    assert a == b and len(set(a)) == 2


def test_compacted_index_saves_as_v6_and_next_add_restarts_ordinals(tmp_path):
    rng = np.random.RandomState(53)
    _, port = _build_both("bits4", _vecs(rng, 30))
    port.add(_vecs(rng, 5))
    port.delete([2])
    port.compact()
    path = str(tmp_path / "c.mvec")
    port.save(path)
    assert open(path, "rb").read()[4] == 6
    assert port.mut.next_ordinal == 1
    port.add(_vecs(rng, 3))
    assert port.mut.extras[0].enc.seed == seg.derive_segment_seed(23, 1)


def test_merge_stage_matches_reference():
    """The candidate-set merge A7/A8 will use, on NEG and -1 padded input."""
    rng = np.random.RandomState(59)
    main_vals = np.sort(rng.randn(4, 5).astype(np.float32), axis=1)[:, ::-1].copy()
    main_vals[1, 3:] = NEG
    main_pos = rng.randint(0, 30, size=(4, 5)).astype(np.int32)
    main_pos[1, 3:] = -1
    side = rng.randn(4, 7).astype(np.float32)
    side[2, :] = NEG
    side[0, 2] = main_vals[0, 0]                          # a tie: the base row wins
    for k in (3, 5, 12):
        got = seg.merge_stage(torch.from_numpy(main_vals), torch.from_numpy(main_pos),
                              torch.from_numpy(side), 30, k)
        want = rseg.merge_stage(jnp.asarray(main_vals), jnp.asarray(main_pos),
                                jnp.asarray(side), 30, k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_live_mask_matches_reference():
    rng = np.random.RandomState(61)
    state = seg.SegmentedState(base_tombs=rng.rand(20) < 0.3)
    rstate = rseg.SegmentedState(base_tombs=state.base_tombs.copy())
    for n in (5, 8):
        tombs = rng.rand(n) < 0.4
        state.extras.append(seg.Segment(enc=None, ids=np.arange(n, dtype=np.uint64),
                                        tombs=tombs))
        rstate.extras.append(rseg.Segment(enc=None, ids=np.arange(n, dtype=np.uint64),
                                          tombs=tombs.copy()))
    mask = rng.rand(33) < 0.5
    for allow in (None, mask):
        got = seg.live_mask(state, None if allow is None else Allowlist(mask, int(mask.sum())),
                            20)
        want = rseg.live_mask(rstate, None if allow is None else RefAllowlist(
            mask=mask, n_allowed=int(mask.sum())), 20)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="build it from MonaVec.ids"):
        seg.live_mask(state, Allowlist(mask[:20], 3), 20)
