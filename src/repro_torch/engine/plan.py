"""Search execution for a static BruteForce index (subset of
``repro/engine/plan.py``).

rotate -> scan -> metric adjustment -> allowlist mask -> NEG pad when
k > n -> stable top-k -> -1 -> SENTINEL_ID.  PyTorch runs eagerly, so each
step is one call on the index's device and nothing is compiled or cached.
The plan cache, shape buckets, ``where=`` predicates, segments and tuned
knobs are ROADMAP A5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import bruteforce as bf_mod
from ..core import quantize as qz
from ..core import segments as seg
from ..core.allowlist import NEG, Allowlist
from ..core.scoring import adjust_scores, topk


def search_backend(
    backend: bf_mod.BruteForceIndex,
    queries,
    k: int,
    *,
    allow: Optional[Allowlist] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [b, k] f32, external ids [b, k] uint64), both numpy on the host.

    Exactly ``k`` columns always; slots with no admissible row carry
    SENTINEL_ID and a NEG score.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    enc = backend.enc
    n = enc.n
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=enc.device))
    if q.shape[-1] != enc.dim:
        raise ValueError(f"queries have dim {q.shape[-1]}, the index has {enc.dim}")
    if allow is not None and allow.mask.shape[0] != n:
        raise ValueError(f"allowlist mask covers {allow.mask.shape[0]} rows but the index "
                         f"has {n}; build it from the index ids")

    q_rot = qz.encode_query(q, enc)
    scores = adjust_scores(bf_mod.scan_stage(q_rot, enc.packed, bits=enc.bits),
                           enc.qnorms, enc.metric)
    if allow is not None:
        scores = allow.apply(scores)
    if n < k:   # k > n: NEG-pad to the full [b, k] contract
        scores = torch.nn.functional.pad(scores, (0, k - n), value=float(NEG))
    vals, pos = topk(scores, k)
    pos = torch.where(vals > float(NEG), pos, -1)
    return vals.cpu().numpy(), seg.rows_to_ids(pos.cpu().numpy(), backend.ids)
