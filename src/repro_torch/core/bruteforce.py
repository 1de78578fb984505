"""BruteForce backend (paper §3.4.1): a linear scan of the packed corpus.

Zero build time beyond the encode, deterministic, memory-compact: the
paper's default index.  The scan is ``ops.score_raw``, which on the card is
the 4-bit or 2-bit CUDA kernel, or both for a mixed corpus; ``search``
routes through ``engine.search_backend``,
which runs the binarized cascade instead when ``rescore_mult`` asks for it
and the index carries coarse codes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import quantize as qz
from .allowlist import Allowlist

#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("scan_stage",)


def scan_stage(q_rot: torch.Tensor, packed: torch.Tensor, *, bits: int,
               n4_dims: int = 0) -> torch.Tensor:
    """Raw full-corpus scan: [b, d'] rotated queries x [n, bytes] codes -> [b, n]."""
    return ops.score_raw(packed, q_rot, bits=bits, n4_dims=n4_dims)


@dataclasses.dataclass
class BruteForceIndex:
    enc: qz.Encoded
    ids: np.ndarray  # [n] external ids (u64 in the .mvec file), on the host
    # On the card: the engine's captured CUDA graphs of searches over this
    # index, by plan key.  They read the index's tensors at fixed addresses
    # and hold them, so they live and die with the index (never copied by
    # dataclasses.replace: a replaced index starts with none).
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    @staticmethod
    def build(
        vectors: torch.Tensor,
        *,
        ids: Optional[np.ndarray] = None,
        metric: str = "cosine",
        seed: int = 0x6D6F6E61,
        bits: int = 4,
        std=None,
        avg_bits: Optional[float] = None,
    ) -> "BruteForceIndex":
        """Encode ``vectors``: at ``bits`` (2 or 4), or mixed 4/2-bit (leading
        dims) when ``avg_bits`` is given and is not 4."""
        if avg_bits is not None and avg_bits != 4:
            enc = qz.encode_mixed(vectors, metric=metric, seed=seed, avg_bits=avg_bits,
                                  std=std)
        else:
            enc = qz.encode(vectors, metric=metric, seed=seed, bits=bits, std=std)
        if ids is None:
            ids = np.arange(vectors.shape[0], dtype=np.uint64)
        return BruteForceIndex(enc=enc, ids=np.asarray(ids, dtype=np.uint64))

    def scores(self, queries: torch.Tensor) -> torch.Tensor:
        """Adjusted scores [b, n] of the full packed corpus."""
        q_rot = qz.encode_query(torch.atleast_2d(queries), self.enc)
        return ops.score_packed(q_rot, self.enc)

    def search(self, queries, k: int, *, allow: Optional[Allowlist] = None,
               **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [b, k], external ids [b, k]) of this one segment through
        the engine; stable top-k, and slots with no admissible row carry
        SENTINEL_ID and a NEG score."""
        from ..engine.plan import search_backend
        return search_backend(self, None, queries, k, allow=allow, **kwargs)
