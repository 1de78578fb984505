"""Build the port's ``Encoded``, metadata columns and a segmented
``MonaVec`` (BruteForce, IVF or HNSW) from plain arrays.

The fields of an encoded corpus (packed codes, norms, seed, shape
metadata and, for a mixed corpus, its 4/2 split and permutation) are the
"weights" of this system; a mutated index adds per-segment ids, tombstones
and the next segment ordinal, an IVF index its centroids and CSR lists, an
HNSW index its graph, an index with metadata its columns and
vocabularies, and a tuned index its autotune result.  Taking them as numpy
arrays lets one index, for example the reference's mutated ``MonaVec``,
feed both packages with the same bytes without going through a file.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import quantize as qz
from .rhdh import next_pow2
from .standardize import METRICS, GlobalStd


def encoded_from_arrays(
    packed: np.ndarray,
    qnorms: np.ndarray,
    *,
    seed: int,
    metric: str,
    bits: int,
    dim: int,
    dim_pad: int,
    n4_dims: int = 0,
    perm: Optional[np.ndarray] = None,
    std_mean: Optional[float] = None,
    std_inv_std: Optional[float] = None,
    device: torch.device | str = "cuda",
) -> qz.Encoded:
    """An Encoded on ``device``; ``bits`` 2, 3 (mixed, with ``n4_dims``
    4-bit dims and optionally the variance permutation ``perm``) or 4."""
    width = qz.bytes_per_vector(dim_pad, bits, n4_dims)   # validates bits
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if dim_pad != next_pow2(dim):
        raise ValueError(f"dim_pad={dim_pad} is not next_pow2(dim={dim})")
    if bits == 3:
        if not 0 <= n4_dims <= dim_pad or n4_dims % 4:
            raise ValueError(f"n4_dims={n4_dims} must be a multiple of 4 in [0, {dim_pad}]")
    elif n4_dims or perm is not None:
        raise ValueError(f"n4_dims and perm belong to mixed (bits=3) corpora, got bits={bits}")
    if perm is not None:
        perm = np.asarray(perm, dtype=np.int32)
        if perm.shape != (dim_pad,) or not np.array_equal(np.sort(perm), np.arange(dim_pad)):
            raise ValueError(f"perm must be a permutation of range({dim_pad})")
    packed = np.asarray(packed, dtype=np.uint8)
    qnorms = np.asarray(qnorms, dtype=np.float32)
    if packed.ndim != 2 or packed.shape[1] != width:
        raise ValueError(f"packed must be [n, {width}], got {packed.shape}")
    if qnorms.shape != (packed.shape[0],):
        raise ValueError(f"qnorms must be [{packed.shape[0]}], got {qnorms.shape}")
    if (std_mean is None) != (std_inv_std is None):
        raise ValueError("pass both std_mean and std_inv_std, or neither")
    std = None if std_mean is None else GlobalStd(float(std_mean), float(std_inv_std))
    dev = resolve_device(device)
    return qz.Encoded(
        packed=torch.tensor(packed, device=dev),
        qnorms=torch.tensor(qnorms, device=dev),
        seed=int(seed), metric=metric, bits=bits, dim=int(dim), dim_pad=int(dim_pad),
        n4_dims=int(n4_dims), std=std, perm=perm,
    )


def meta_from_arrays(columns: Mapping[str, Tuple[str, np.ndarray, Optional[Sequence[str]]]]):
    """A ``MetaStore`` of columns given as ``{name: (kind, values, vocab)}``
    in schema order: kind "i64", "f64" or "str", the values (int32 codes
    for str) and the str column's vocabulary (None otherwise), taken as
    they are, so the values and vocabularies keep their bytes."""
    import collections

    from . import metadata as md

    cols = collections.OrderedDict()
    for name, (kind, values, vocab) in columns.items():
        if kind not in md.KINDS:
            raise ValueError(f"metadata column {name!r}: unknown kind {kind!r}")
        values = np.ascontiguousarray(np.asarray(values).astype(
            {md.KIND_I64: np.int64, md.KIND_F64: np.float64, md.KIND_STR: np.int32}[kind]))
        if values.ndim != 1:
            raise ValueError(f"metadata column {name!r} must be 1-D, got {values.shape}")
        if (vocab is None) != (kind != md.KIND_STR):
            raise ValueError(f"metadata column {name!r}: a vocabulary goes with kind 'str' "
                             f"and only with it")
        if kind == md.KIND_F64 and np.isnan(values).any():
            raise ValueError(f"metadata column {name!r} contains NaN")
        if kind == md.KIND_STR and values.size and (values.min() < 0
                                                    or values.max() >= len(vocab)):
            raise ValueError(f"metadata column {name!r}: a code is outside the vocabulary")
        cols[name] = md.Column(kind=kind, values=values,
                               vocab=None if vocab is None else list(vocab))
    if len({c.n for c in cols.values()}) > 1:
        raise ValueError("metadata columns differ in length")
    return md.MetaStore(columns=cols)


def tune_from_fields(tune):
    """The port's ``TuneResult`` with the fields of ``tune``, any object with
    a TuneResult's attribute names (the reference's, for one), or None:
    ``recall_target``, ``k``, ``n_queries``, ``seed``, ``met_target``,
    ``knobs``, ``ladder`` (name -> rungs with ``value`` and ``recall``) and
    ``boost`` (None, or ``points`` with ``selectivity``, ``mult`` and
    ``recall``)."""
    from ..tune.result import BoostCurve, BoostPoint, KnobRung, TuneResult

    if tune is None:
        return None
    boost = None if tune.boost is None else BoostCurve(points=tuple(
        BoostPoint(selectivity=float(p.selectivity), mult=int(p.mult), recall=float(p.recall))
        for p in tune.boost.points))
    return TuneResult(
        recall_target=float(tune.recall_target), k=int(tune.k), n_queries=int(tune.n_queries),
        seed=int(tune.seed), met_target=bool(tune.met_target),
        knobs={str(name): int(v) for name, v in dict(tune.knobs).items()},
        ladder={str(name): tuple(KnobRung(value=int(r.value), recall=float(r.recall))
                                 for r in rungs) for name, rungs in dict(tune.ladder).items()},
        boost=boost)


def segmented_from_arrays(
    segments: Sequence[dict],
    *,
    next_ordinal: int,
    metric: str,
    bits: int,
    dim: int,
    dim_pad: int,
    n4_dims: int = 0,
    perm: Optional[np.ndarray] = None,
    std_mean: Optional[float] = None,
    std_inv_std: Optional[float] = None,
    coarse: Optional[str] = None,
    ivf: Optional[dict] = None,
    hnsw: Optional[dict] = None,
    meta=None,
    device: torch.device | str = "cuda",
):
    """A ``MonaVec`` over segments given base first, each a dict of
    ``packed``, ``qnorms``, ``seed``, ``ids`` and ``tombs`` ([n] bool); with
    ``coarse`` every segment derives its coarse code from its codes.  With
    ``ivf`` (a dict of ``centroids`` [nlist, d'] f32, ``order`` [n], ``offsets``
    [nlist + 1] and ``nlist``) the base is an IVF index over those lists;
    with ``hnsw`` (a dict of ``neighbors0`` [n, 2M], ``neighbors_hi``
    [max_level, n, M], ``node_level`` [n], ``entry_point``, ``max_level``,
    ``m`` and ``ef_construction`` (None: unknown)) an HNSW index over that
    graph; ``meta`` is a ``MetaStore`` over every segment's rows."""
    from . import binary
    from . import segments as seg
    from .api import MonaVec
    from .bruteforce import BruteForceIndex
    from .hnsw import HnswIndex
    from .ivf import IvfFlatIndex

    if not segments:
        raise ValueError("segments must hold at least the base segment")
    if next_ordinal < len(segments):
        raise ValueError(f"next_ordinal={next_ordinal} is below the {len(segments)} "
                         f"segments given")
    parts = []
    for s in segments:
        enc = encoded_from_arrays(s["packed"], s["qnorms"], seed=s["seed"], metric=metric,
                                  bits=bits, dim=dim, dim_pad=dim_pad, n4_dims=n4_dims,
                                  perm=perm, std_mean=std_mean, std_inv_std=std_inv_std,
                                  device=device)
        if coarse is not None:
            enc = binary.attach_coarse(enc, coarse)
        ids = np.asarray(s["ids"], dtype=np.uint64)
        tombs = np.asarray(s["tombs"], dtype=bool).copy()
        if ids.shape != (enc.n,) or tombs.shape != (enc.n,):
            raise ValueError(f"ids and tombs must be [{enc.n}], got {ids.shape} and "
                             f"{tombs.shape}")
        parts.append((enc, ids, tombs))
    (enc0, ids0, tombs0), extras = parts[0], parts[1:]
    state = seg.SegmentedState(
        base_tombs=tombs0, next_ordinal=int(next_ordinal),
        extras=[seg.Segment(enc=e, ids=i, tombs=t) for e, i, t in extras])
    if (ivf is not None or hnsw is not None) and coarse is not None:
        raise ValueError("coarse codes belong to the bruteforce index")
    if ivf is not None and hnsw is not None:
        raise ValueError("pass ivf= or hnsw=, not both")
    if hnsw is not None:
        m = int(hnsw["m"])
        nbr0 = np.asarray(hnsw["neighbors0"], dtype=np.int32)
        max_level = int(hnsw["max_level"])
        nbr_hi = np.asarray(hnsw["neighbors_hi"], dtype=np.int32).reshape(max_level, enc0.n, m)
        levels = np.asarray(hnsw["node_level"], dtype=np.int8)
        entry = int(hnsw["entry_point"])
        if nbr0.shape != (enc0.n, 2 * m) or levels.shape != (enc0.n,):
            raise ValueError(f"neighbors0 must be [{enc0.n}, {2 * m}] and node_level "
                             f"[{enc0.n}], got {nbr0.shape} and {levels.shape}")
        if enc0.n and not 0 <= entry < enc0.n:
            raise ValueError(f"entry_point {entry} is not a row of the base segment")
        if nbr0.size and (nbr0.min() < -1 or nbr0.max() >= enc0.n) or nbr_hi.size and (
                nbr_hi.min() < -1 or nbr_hi.max() >= enc0.n):
            raise ValueError("a neighbour is neither -1 nor a row of the base segment")
        efc = hnsw.get("ef_construction")
        backend = HnswIndex(enc=enc0, ids=ids0, neighbors0=nbr0, neighbors_hi=nbr_hi,
                            node_level=levels, entry_point=entry, max_level=max_level, m=m,
                            ef_construction=None if efc is None else int(efc))
    elif ivf is None:
        backend = BruteForceIndex(enc=enc0, ids=ids0)
    else:
        nlist = int(ivf["nlist"])
        cents = np.asarray(ivf["centroids"], dtype=np.float32)
        order = np.asarray(ivf["order"], dtype=np.int64)
        offsets = np.asarray(ivf["offsets"], dtype=np.int64)
        if cents.shape != (nlist, dim_pad) or offsets.shape != (nlist + 1,):
            raise ValueError(f"centroids must be [{nlist}, {dim_pad}] and offsets "
                             f"[{nlist + 1}], got {cents.shape} and {offsets.shape}")
        if (not np.array_equal(np.sort(order), np.arange(enc0.n)) or offsets[0] != 0
                or offsets[-1] != enc0.n or (np.diff(offsets) < 0).any()):
            raise ValueError("order must permute the base rows and offsets run from 0 "
                             "to n, non-decreasing")
        backend = IvfFlatIndex(enc=enc0, ids=ids0, centroids=torch.from_numpy(cents.copy()),
                               order=order, offsets=offsets, nlist=nlist)
    if meta is not None and meta.n_rows != sum(e.n for e, _, _ in parts):
        raise ValueError(f"metadata has {meta.n_rows} rows but the segments "
                         f"{sum(e.n for e, _, _ in parts)}")
    return MonaVec(backend, mut=state, meta=meta)


def ivf_from_arrays(packed: np.ndarray, qnorms: np.ndarray, *, ids: np.ndarray,
                    centroids: np.ndarray, order: np.ndarray, offsets: np.ndarray,
                    nlist: int, seed: int, metric: str, bits: int, dim: int, dim_pad: int,
                    std_mean: Optional[float] = None, std_inv_std: Optional[float] = None,
                    meta=None, device: torch.device | str = "cuda"):
    """A static IVF ``MonaVec`` over an encoded corpus and its lists."""
    return segmented_from_arrays(
        [{"packed": packed, "qnorms": qnorms, "seed": seed, "ids": ids,
          "tombs": np.zeros(np.asarray(packed).shape[0], dtype=bool)}],
        next_ordinal=1, metric=metric, bits=bits, dim=dim, dim_pad=dim_pad,
        std_mean=std_mean, std_inv_std=std_inv_std, meta=meta,
        ivf={"centroids": centroids, "order": order, "offsets": offsets, "nlist": nlist},
        device=device)


def hnsw_from_arrays(packed: np.ndarray, qnorms: np.ndarray, *, ids: np.ndarray,
                     neighbors0: np.ndarray, neighbors_hi: np.ndarray, node_level: np.ndarray,
                     entry_point: int, max_level: int, m: int,
                     ef_construction: Optional[int], seed: int, metric: str, bits: int,
                     dim: int, dim_pad: int, std_mean: Optional[float] = None,
                     std_inv_std: Optional[float] = None, meta=None,
                     device: torch.device | str = "cuda"):
    """A static HNSW ``MonaVec`` over an encoded corpus and its graph."""
    return segmented_from_arrays(
        [{"packed": packed, "qnorms": qnorms, "seed": seed, "ids": ids,
          "tombs": np.zeros(np.asarray(packed).shape[0], dtype=bool)}],
        next_ordinal=1, metric=metric, bits=bits, dim=dim, dim_pad=dim_pad,
        std_mean=std_mean, std_inv_std=std_inv_std, meta=meta,
        hnsw={"neighbors0": neighbors0, "neighbors_hi": neighbors_hi,
              "node_level": node_level, "entry_point": entry_point, "max_level": max_level,
              "m": m, "ef_construction": ef_construction},
        device=device)
