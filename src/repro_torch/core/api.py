"""MonaVec facade for the BruteForce and IVF indexes (subset of
``repro/core/api.py``).

    idx = MonaVec.build(vectors, metric="cosine")        # on the card
    scores, ids = idx.search(queries, k=10)
    idx.save("corpus.mvec");  idx2 = MonaVec.load("corpus.mvec")

    idx = MonaVec.build(vectors, coarse="sign")           # or "crumb"
    scores, ids = idx.search(queries, k=10, rescore_mult=8)   # the cascade

    idx = MonaVec.build(vectors, bits=2)                  # 2-bit codes
    idx = MonaVec.build(vectors, avg_bits=3.0)            # mixed 4/2-bit, leading dims

    idx = MonaVec.build(vectors, index="ivf", nlist=64, train_iters=25)
    scores, ids = idx.search(queries, k=10, nprobe=16)    # IVF, nprobe <= nlist

    idx = MonaVec.build(vectors, meta={"lang": langs, "date": dates})
    scores, ids = idx.search(queries, k=10, where=Eq("lang", "en") & Ge("date", 20260101))

    idx.add(new_vectors)            # quantizes a new segment (derived seed)
    idx.delete([3, 17])             # tombstones rows, codes untouched
    idx.compact()                   # deterministic rewrite into one segment
    search = idx.searcher(k=10).warmup(64)               # bound handle
    scores, ids = search(queries)

A mixed index with a variance permutation is built from a
``quantize.encode_mixed(..., perm=quantize.variance_permutation(sample))``
encoding as ``MonaVec(BruteForceIndex(enc=enc, ids=ids))``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
The index lives on that device (``add`` and ``compact`` encode there, and an
IVF build clusters there); ids, tombstones, metadata values and results are
numpy arrays on the host.  Every search runs through the engine
(``repro_torch.engine``): on the card one captured CUDA graph per plan,
replayed.  ``save`` writes v10 with coarse codes, v9 with metadata columns,
v8 once the index is mutated, v7 with a permutation and v6 otherwise; an IVF
index carries its centroids and lists in INDEX_DATA.  HNSW is ROADMAP A8;
autotuning and sharding are A11 and A12.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import binary
from . import mvec_format as fmt
from . import segments as seg
from .allowlist import Allowlist
from .bruteforce import BruteForceIndex
from .convert import encoded_from_arrays
from .ivf import IvfFlatIndex
from .metadata import MetaStore
from .standardize import COSINE, GlobalStd

Backend = Union[BruteForceIndex, IvfFlatIndex]
_TYPE_CODE = {BruteForceIndex: fmt.INDEX_BRUTEFORCE, IvfFlatIndex: fmt.INDEX_IVF}
_IVF_BUILD_KNOBS = frozenset({"nlist", "train_iters"})


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _unported_index(index: str) -> NotImplementedError:
    return NotImplementedError(f"index={index!r} is not ported yet (ROADMAP A8); the port "
                               f"has index='bruteforce' and index='ivf'")


@dataclasses.dataclass
class MonaVec:
    backend: Backend
    mut: Optional[seg.SegmentedState] = None
    meta: Optional[MetaStore] = None     # per-row metadata columns (v9)

    def __post_init__(self):
        if self.mut is None:
            self.mut = seg.SegmentedState.fresh(self.backend.enc.n)

    # -- construction ------------------------------------------------------

    @staticmethod
    def fit(sample) -> GlobalStd:
        """Single-pass global standardization for L2 corpora (paper fit())."""
        return GlobalStd.fit(sample)

    @staticmethod
    def build(
        vectors,
        *,
        metric: str = COSINE,
        index: str = "bruteforce",
        seed: int = 0x6D6F6E61,
        bits: int = 4,
        avg_bits: Optional[float] = None,
        std: Optional[GlobalStd] = None,
        ids: Optional[np.ndarray] = None,
        meta: Optional[dict] = None,
        coarse: Optional[str] = None,
        autotune=None,
        device: torch.device | str = "cuda",
        **kwargs,
    ) -> "MonaVec":
        """Encode and index ``vectors`` at ``bits`` (2 or 4), or mixed 4/2-bit
        when ``avg_bits`` is given and is not 4; ``index="ivf"`` also clusters
        them (``nlist`` cells, ``train_iters`` Lloyd iterations, the
        reference's defaults 64 and 25); ``meta`` names per-row columns
        (int, float or str arrays of len(vectors))."""
        if coarse is not None and index != "bruteforce":
            raise ValueError("coarse= (the binarized cascade) requires the bruteforce "
                             f"index, got index={index!r}")
        if index == "hnsw":
            raise _unported_index(index)
        if index not in ("bruteforce", "ivf"):
            raise ValueError(f"unknown index {index!r}")
        unknown = sorted(set(kwargs) - (_IVF_BUILD_KNOBS if index == "ivf" else set()))
        if unknown:
            raise TypeError(f"unexpected build kwargs for index={index!r}: {unknown}")
        if index == "ivf" and avg_bits is not None and avg_bits != 4:
            raise ValueError("avg_bits (mixed precision) requires the bruteforce index")
        if autotune is not None and autotune is not False:
            raise _unported("autotune=", "A11")
        dev = resolve_device(device)
        x = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
        store = MetaStore.build(meta, int(x.shape[0])) if meta else None
        if index == "ivf":
            be: Backend = IvfFlatIndex.build(x, metric=metric, seed=seed, bits=bits,
                                             std=std, ids=ids, **kwargs)
        else:
            be = BruteForceIndex.build(x, metric=metric, seed=seed, bits=bits, std=std,
                                       ids=ids, avg_bits=avg_bits)
        idx = MonaVec(be, meta=store)
        if coarse is not None:
            idx.enable_coarse(coarse)
        return idx

    @staticmethod
    def from_arrays(
        packed: np.ndarray,
        qnorms: np.ndarray,
        *,
        seed: int,
        metric: str,
        bits: int,
        dim: int,
        dim_pad: int,
        ids: Optional[np.ndarray] = None,
        n4_dims: int = 0,
        perm: Optional[np.ndarray] = None,
        std_mean: Optional[float] = None,
        std_inv_std: Optional[float] = None,
        device: torch.device | str = "cuda",
    ) -> "MonaVec":
        """An index over an already-encoded corpus (see ``core.convert``)."""
        enc = encoded_from_arrays(packed, qnorms, seed=seed, metric=metric, bits=bits,
                                  dim=dim, dim_pad=dim_pad, n4_dims=n4_dims, perm=perm,
                                  std_mean=std_mean, std_inv_std=std_inv_std,
                                  device=device)
        if ids is None:
            ids = np.arange(enc.n, dtype=np.uint64)
        return MonaVec(BruteForceIndex(enc=enc, ids=np.asarray(ids, dtype=np.uint64)))

    # -- introspection -----------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.backend.enc.device

    @property
    def ids(self) -> np.ndarray:
        """External ids of every row (tombstoned included), in segment
        order: the id universe allowlists are built against."""
        if not self.mut.extras:
            return self.backend.ids
        return np.concatenate([self.backend.ids] + [s.ids for s in self.mut.extras])

    @property
    def n_total(self) -> int:
        return int(self.backend.enc.n + sum(s.n for s in self.mut.extras))

    @property
    def n_live(self) -> int:
        dead = int(self.mut.base_tombs.sum()) + sum(int(s.tombs.sum())
                                                   for s in self.mut.extras)
        return self.n_total - dead

    def _live_masks(self) -> list:
        return [~self.mut.base_tombs] + [~s.tombs for s in self.mut.extras]

    # -- mutation lifecycle (DESIGN.md §6) ---------------------------------

    def add(self, vectors, ids: Optional[Sequence[int]] = None,
            meta: Optional[dict] = None) -> np.ndarray:
        """Append a new immutable segment, quantized on the index's device
        under ``derive_segment_seed(root, ordinal)``; returns the assigned
        external ids.  Ids duplicating a live row are rejected (tombstoned
        ids may be reused).  An index with metadata columns needs ``meta``
        for every batch, with exactly its schema; one without rejects it."""
        if self.meta is not None and meta is None:
            raise ValueError(f"add: this index has metadata columns "
                             f"{[n for n, _ in self.meta.schema]}; pass meta= for the batch")
        if self.meta is None and meta is not None:
            raise ValueError("add: meta= given but the index was built without metadata "
                             "columns")
        x = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32))
        n_new = int(x.shape[0])
        if n_new == 0:
            return np.zeros(0, dtype=np.uint64)
        base = self.backend.enc
        if x.shape[1] != base.dim:
            raise ValueError(f"add: expected dim {base.dim}, got {x.shape[1]}")
        if ids is None:
            new_ids = np.arange(n_new, dtype=np.uint64) + (
                np.uint64(0) if self.n_total == 0 else self.ids.max() + np.uint64(1))
        else:
            new_ids = np.asarray(list(ids), dtype=np.uint64)
            if new_ids.shape[0] != n_new:
                raise ValueError("add: len(ids) != len(vectors)")
        if np.unique(new_ids).shape[0] != n_new:
            raise ValueError("add: duplicate ids within the batch")
        live_ids = np.concatenate([i[m] for i, m in zip(
            [self.backend.ids] + [s.ids for s in self.mut.extras], self._live_masks())])
        clash = np.intersect1d(new_ids, live_ids)
        if clash.size:
            raise ValueError(f"add: ids already live in the index: {clash[:8].tolist()}")
        if self.meta is not None:
            self.meta.append(meta, n_new)    # validates every column before it commits
        seed = seg.derive_segment_seed(base.seed, self.mut.next_ordinal)
        enc = seg.encode_segment(x.to(base.device), base, seed)
        self.mut.extras.append(seg.Segment(enc=enc, ids=new_ids,
                                           tombs=np.zeros(n_new, dtype=bool)))
        self.mut.next_ordinal += 1
        self.backend.graphs.clear()     # they read the old segment set
        return new_ids

    def delete(self, ids: Sequence[int]) -> int:
        """Tombstone every live row whose external id is in ``ids``; codes
        are never rewritten.  Returns the number of rows newly tombstoned."""
        targets = np.asarray(list(ids), dtype=np.uint64)
        hit = np.isin(self.backend.ids, targets) & ~self.mut.base_tombs
        self.mut.base_tombs |= hit
        n = int(hit.sum())
        for s in self.mut.extras:
            hit = np.isin(s.ids, targets) & ~s.tombs
            s.tombs |= hit
            n += int(hit.sum())
        return n

    def compact(self) -> int:
        """Rewrite the live rows into one fresh base segment under the root
        seed, on the index's device: each segment's live codes are decoded,
        carried back through the inverse rotation of its seed and encoded
        again, a pure function of the current codes, so two equal op
        sequences compact to byte-identical indexes.  An IVF index is
        clustered again over the live rows (``nlist = min(nlist, n_live)``),
        and metadata columns keep the live rows.  Returns the number of dead
        rows reclaimed."""
        reclaimed = self.n_total - self.n_live
        if not self.mut.extras and reclaimed == 0:
            return 0
        if self.n_live == 0:
            raise ValueError("compact: no live rows to rewrite")
        if self.meta is not None:
            self.meta = self.meta.gather(np.concatenate(self._live_masks()))
        encs = [self.backend.enc] + [s.enc for s in self.mut.extras]
        all_ids = [self.backend.ids] + [s.ids for s in self.mut.extras]
        vec_parts, id_parts = [], []
        for enc, sids, live in zip(encs, all_ids, self._live_masks()):
            if live.any():
                rows = torch.as_tensor(np.flatnonzero(live)).to(enc.device)
                vec_parts.append(seg.reconstruct_vectors(enc)[rows])
                id_parts.append(sids[live])
        base = self.backend.enc
        live_vecs, live_ids = torch.cat(vec_parts), np.concatenate(id_parts)
        if isinstance(self.backend, IvfFlatIndex):
            self.backend = IvfFlatIndex.build(
                live_vecs, ids=live_ids, metric=base.metric, seed=base.seed, bits=base.bits,
                std=base.std, nlist=min(self.backend.nlist, live_ids.shape[0]))
        else:
            enc = seg.encode_segment(live_vecs, base, base.seed)
            self.backend = BruteForceIndex(enc=enc, ids=live_ids)
        self.mut = seg.SegmentedState.fresh(self.backend.enc.n)
        return reclaimed

    # -- the binarized cascade ---------------------------------------------

    def enable_coarse(self, kind: str = "sign") -> "MonaVec":
        """Derive and attach the binarized coarse code ("sign" or "crumb") to
        every segment, in place: a pure function of the packed codes, so
        enabling it on a loaded v6 index gives the codes a ``coarse=`` build
        would have saved.  Unlocks ``search(..., rescore_mult=r)``."""
        if not isinstance(self.backend, BruteForceIndex):
            raise TypeError("the binarized cascade requires the bruteforce backend, got "
                            f"{type(self.backend).__name__}")
        self.backend = dataclasses.replace(
            self.backend, enc=binary.attach_coarse(self.backend.enc, kind))
        for s in self.mut.extras:
            s.enc = binary.attach_coarse(s.enc, kind)
        return self

    def resolved_knobs(self, k: int = 10, **kwargs) -> dict:
        """The knobs ``search(queries, k, **kwargs)`` runs with, after the
        ``nprobe <= nlist`` clamp and the ``rescore_mult`` rules; an empty
        dict means the full scan."""
        from ..engine.plan import resolve_knobs
        return resolve_knobs(self.backend, None if self.mut.is_static else self.mut, k,
                             **kwargs)

    def autotune(self, *args, **kwargs):
        raise _unported("autotune", "A11")

    def shard(self, mesh=None):
        raise _unported("shard", "A12")

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int = 10, *, allow: Optional[Allowlist] = None,
               where=None, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over every segment, through one plan of the engine: rotate
        -> predicate mask -> scan -> adjust -> live mask (tombstones,
        allowlist, predicate) -> stable top-k; with ``rescore_mult=r`` the
        cascade (coarse proxy -> r*k survivors per segment -> gathered
        rescore); on an IVF index the probe of ``nprobe`` cells, their
        gathered scan and the extra segments' full scans, merged.  ``where``
        is a ``predicate.Predicate`` over the metadata columns.  Always
        exactly ``k`` columns; inadmissible slots carry SENTINEL_ID/NEG.
        Allowlists are built from ``MonaVec.ids``."""
        from ..engine.plan import search_backend
        return search_backend(self.backend, None if self.mut.is_static else self.mut,
                              queries, k, allow=allow, where=where, meta=self.meta, **kwargs)

    def searcher(self, k: int = 10, *, where=None, **kwargs):
        """Bound search handle: ``s = idx.searcher(k=10, where=p, nprobe=16);
        s(queries)``.  It resolves its plan through the shared cache on every
        call, so it tracks add/delete/compact, and ``s.warmup(batch_size)``
        builds (on the card: captures) the plan of that batch's bucket ahead
        of the traffic."""
        from ..engine.plan import Searcher
        return Searcher(self, k=k, where=where, knobs=kwargs)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        be = self.backend
        blob, param = None, 0
        if isinstance(be, IvfFlatIndex):
            blob = fmt.pack_ivf_blob(be.centroids.cpu().numpy(), be.order, be.offsets)
            param = be.nlist
        fmt.save(path, fmt.MvecFile(
            enc=be.enc, ids=be.ids, index_type=_TYPE_CODE[type(be)], index_param=param,
            index_data=blob,
            extras=[fmt.ExtraSegment(enc=s.enc, ids=s.ids) for s in self.mut.extras],
            tombs=[self.mut.base_tombs] + [s.tombs for s in self.mut.extras],
            meta=self.meta))

    @staticmethod
    def load(path: str, device: torch.device | str = "cuda") -> "MonaVec":
        dev = resolve_device(device)
        f = fmt.load(path, dev)
        if f.index_type == fmt.INDEX_BRUTEFORCE:
            be: Backend = BruteForceIndex(enc=f.enc, ids=f.ids)
        elif f.index_type == fmt.INDEX_IVF:
            cents, order, offsets = fmt.unpack_ivf_blob(f.index_data or b"")
            be = IvfFlatIndex(enc=f.enc, ids=f.ids, centroids=torch.from_numpy(cents.copy()),
                              order=order, offsets=offsets, nlist=f.index_param)
        elif f.index_type == fmt.INDEX_HNSW:
            raise _unported_index("hnsw")
        else:
            raise ValueError(f"unknown index type {f.index_type}")
        mut = seg.SegmentedState(
            base_tombs=(f.tombs[0] if f.tombs is not None
                        else np.zeros(f.enc.n, dtype=bool)),
            extras=[seg.Segment(enc=e.enc, ids=e.ids, tombs=f.tombs[i + 1])
                    for i, e in enumerate(f.extras)],
            next_ordinal=len(f.extras) + 1)
        return MonaVec(be, mut=mut, meta=f.meta)
