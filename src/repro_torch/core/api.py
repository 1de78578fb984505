"""MonaVec facade for the BruteForce index (subset of ``repro/core/api.py``).

    idx = MonaVec.build(vectors, metric="cosine")        # on the card
    scores, ids = idx.search(queries, k=10)
    idx.save("corpus.mvec");  idx2 = MonaVec.load("corpus.mvec")

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
The index lives on that device; ids and results come back as numpy arrays
on the host.  IVF and HNSW are ROADMAP A7 and A8; mutation, metadata,
the binarized cascade and autotuning follow them in ROADMAP A.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
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
        std: Optional[GlobalStd] = None,
        ids: Optional[np.ndarray] = None,
        device: torch.device | str = "cuda",
    ) -> "MonaVec":
        _require_bruteforce(index)
        dev = resolve_device(device)
        x = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
        return MonaVec(BruteForceIndex.build(x, metric=metric, seed=seed, bits=bits,
                                             std=std, ids=ids))

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
        std_mean: Optional[float] = None,
        std_inv_std: Optional[float] = None,
        device: torch.device | str = "cuda",
    ) -> "MonaVec":
        """An index over an already-encoded corpus (see ``core.convert``)."""
        enc = encoded_from_arrays(packed, qnorms, seed=seed, metric=metric, bits=bits,
                                  dim=dim, dim_pad=dim_pad, std_mean=std_mean,
                                  std_inv_std=std_inv_std, device=device)
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

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int = 10, *,
               allow: Optional[Allowlist] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k: rotate -> scan -> adjust -> allowlist mask -> stable top-k.
        Always exactly ``k`` columns; inadmissible slots carry SENTINEL_ID/NEG."""
        return self.backend.search(queries, k, allow=allow)

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
