"""Build the port's ``Encoded``, metadata columns and a segmented
``MonaVec`` (BruteForce or IVF) from plain arrays.

The fields of an encoded corpus (packed codes, norms, seed, shape
metadata and, for a mixed corpus, its 4/2 split and permutation) are the
"weights" of this system; a mutated index adds per-segment ids, tombstones
and the next segment ordinal, an IVF index its centroids and CSR lists, and
an index with metadata its columns and vocabularies.  Taking them as numpy
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
    meta=None,
    device: torch.device | str = "cuda",
):
    """A ``MonaVec`` over segments given base first, each a dict of
    ``packed``, ``qnorms``, ``seed``, ``ids`` and ``tombs`` ([n] bool); with
    ``coarse`` every segment derives its coarse code from its codes.  With
    ``ivf`` (a dict of ``centroids`` [nlist, d'] f32, ``order`` [n], ``offsets``
    [nlist + 1] and ``nlist``) the base is an IVF index over those lists;
    ``meta`` is a ``MetaStore`` over every segment's rows."""
    from . import binary
    from . import segments as seg
    from .api import MonaVec
    from .bruteforce import BruteForceIndex
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
    if ivf is None:
        backend = BruteForceIndex(enc=enc0, ids=ids0)
    else:
        if coarse is not None:
            raise ValueError("coarse codes belong to the bruteforce index")
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
