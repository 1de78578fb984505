"""MonaVec facade for the BruteForce index (subset of ``repro/core/api.py``).

    idx = MonaVec.build(vectors, metric="cosine")        # on the card
    scores, ids = idx.search(queries, k=10)
    idx.save("corpus.mvec");  idx2 = MonaVec.load("corpus.mvec")

    idx = MonaVec.build(vectors, coarse="sign")           # or "crumb"
    scores, ids = idx.search(queries, k=10, rescore_mult=8)   # the cascade

    idx = MonaVec.build(vectors, bits=2)                  # 2-bit codes
    idx = MonaVec.build(vectors, avg_bits=3.0)            # mixed 4/2-bit, leading dims

A mixed index with a variance permutation is built from a
``quantize.encode_mixed(..., perm=quantize.variance_permutation(sample))``
encoding as ``MonaVec(BruteForceIndex(enc=enc, ids=ids))``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
The index lives on that device; ids and results come back as numpy arrays
on the host.  An index with coarse codes saves as a static v10 file, one
with a permutation and no coarse codes as v7, any other as v6.  IVF and
HNSW are ROADMAP A7 and A8; mutation, metadata and autotuning are A4, A6
and A11.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import binary
from . import mvec_format as fmt
from .allowlist import Allowlist
from .bruteforce import BruteForceIndex
from .convert import encoded_from_arrays
from .standardize import COSINE, GlobalStd

_UNPORTED_INDEX = {"ivf": "ROADMAP A7", "hnsw": "ROADMAP A8"}


def _require_bruteforce(index: str) -> None:
    if index in _UNPORTED_INDEX:
        raise NotImplementedError(
            f"index={index!r} is not ported yet ({_UNPORTED_INDEX[index]}); "
            f"the port has index='bruteforce'")
    if index != "bruteforce":
        raise ValueError(f"unknown index {index!r}")


@dataclasses.dataclass
class MonaVec:
    backend: BruteForceIndex

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
        coarse: Optional[str] = None,
        device: torch.device | str = "cuda",
    ) -> "MonaVec":
        """Encode and index ``vectors`` at ``bits`` (2 or 4), or mixed 4/2-bit
        when ``avg_bits`` is given and is not 4."""
        if coarse is not None and index != "bruteforce":
            raise ValueError("coarse= (the binarized cascade) requires the bruteforce "
                             f"index, got index={index!r}")
        _require_bruteforce(index)
        dev = resolve_device(device)
        x = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
        idx = MonaVec(BruteForceIndex.build(x, metric=metric, seed=seed, bits=bits,
                                            std=std, ids=ids, avg_bits=avg_bits))
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
        return self.backend.ids

    # -- the binarized cascade ---------------------------------------------

    def enable_coarse(self, kind: str = "sign") -> "MonaVec":
        """Derive and attach the binarized coarse code ("sign" or "crumb"), in
        place: a pure function of the packed codes, so enabling it on a loaded
        v6 index gives the codes a ``coarse=`` build would have saved.
        Unlocks ``search(..., rescore_mult=r)``."""
        self.backend = dataclasses.replace(
            self.backend, enc=binary.attach_coarse(self.backend.enc, kind))
        return self

    def resolved_knobs(self, k: int = 10, **kwargs) -> dict:
        """The knobs ``search(queries, k, **kwargs)`` runs with, after the
        ``rescore_mult`` rules; an empty dict means the full scan."""
        from ..engine.plan import resolve_knobs
        return resolve_knobs(self.backend, k, **kwargs)

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int = 10, *, allow: Optional[Allowlist] = None,
               rescore_mult: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k: rotate -> scan -> adjust -> allowlist mask -> stable top-k,
        or with ``rescore_mult=r`` the cascade: coarse proxy -> r*k survivors
        -> gathered rescore -> stable top-k.  Always exactly ``k``
        columns; inadmissible slots carry SENTINEL_ID/NEG."""
        return self.backend.search(queries, k, allow=allow, rescore_mult=rescore_mult)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        be = self.backend
        fmt.save(path, fmt.MvecFile(enc=be.enc, ids=be.ids,
                                    index_type=fmt.INDEX_BRUTEFORCE))

    @staticmethod
    def load(path: str, device: torch.device | str = "cuda") -> "MonaVec":
        dev = resolve_device(device)
        f = fmt.load(path, dev)
        if f.index_type != fmt.INDEX_BRUTEFORCE:
            _require_bruteforce({fmt.INDEX_IVF: "ivf", fmt.INDEX_HNSW: "hnsw"}.get(
                f.index_type, f"index type {f.index_type}"))
        return MonaVec(BruteForceIndex(enc=f.enc, ids=f.ids))
