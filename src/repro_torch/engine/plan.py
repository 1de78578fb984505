"""Search execution for a static BruteForce index (subset of
``repro/engine/plan.py``).

Full scan: rotate -> scan -> metric adjustment -> allowlist mask -> NEG pad
when k > n -> stable top-k -> -1 -> SENTINEL_ID.

Binarized cascade (``rescore_mult=r``, DESIGN.md §11): rotate -> coarse
integer proxy over every row -> top m = r*k survivors over the live mask
(the allowlist) -> gathered rescore of the survivors at the corpus's own
precision -> stable top-k -> positions -> SENTINEL_ID.  The rotation applies
the corpus's variance permutation (v7), so the coarse stage and both scans
read the permuted query.  Dead survivors carry NEG.  Since m = r*k >= k,
a static index never has fewer survivor slots than k.

PyTorch runs eagerly, so each step is one call on the index's device and
nothing is compiled or cached.  The plan cache, shape buckets, ``where=``
predicates, segments and tuned knobs are ROADMAP A5, A6, A4 and A11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import binary
from ..core import bruteforce as bf_mod
from ..core import quantize as qz
from ..core import segments as seg
from ..core.allowlist import NEG, Allowlist
from ..core.scoring import adjust_scores, topk

#: Search knobs the BruteForce backend takes.
KNOBS = frozenset({"rescore_mult"})


def resolve_knobs(backend: bf_mod.BruteForceIndex, k: int, **kwargs) -> dict:
    """The knobs a search with these arguments runs with; {} is the full scan.

    ``rescore_mult`` of None or 0 is the full scan, a negative one raises, an
    index without coarse codes raises, and ``rescore_mult * k >= n`` (a
    rescore of every row) collapses to the full scan.
    """
    unknown = sorted(set(kwargs) - KNOBS)
    if unknown:
        raise TypeError(f"unexpected search kwargs for the BruteForceIndex backend: {unknown}")
    rm = kwargs.get("rescore_mult")
    rm = 0 if rm is None else int(rm)
    if rm < 0:
        raise ValueError(f"rescore_mult must be >= 0, got {rm}")
    if rm == 0:
        return {}
    if backend.enc.ccodes is None:
        raise ValueError(
            "rescore_mult requires an index built with a binarized coarse code "
            "(MonaVec.build(..., coarse='sign'|'crumb'))")
    if rm * k >= backend.enc.n:
        return {}   # a rescore of every row is the full scan
    return {"rescore_mult": rm}


def _full_scan(enc: qz.Encoded, q_rot: torch.Tensor, k: int,
               allow: Optional[Allowlist]) -> Tuple[torch.Tensor, torch.Tensor]:
    scores = adjust_scores(bf_mod.scan_stage(q_rot, enc.packed, bits=enc.bits,
                                             n4_dims=enc.n4_dims),
                           enc.qnorms, enc.metric)
    if allow is not None:
        scores = allow.apply(scores)
    if enc.n < k:   # k > n: NEG-pad to the full [b, k] contract
        scores = torch.nn.functional.pad(scores, (0, k - enc.n), value=float(NEG))
    return topk(scores, k)


def _cascade(enc: qz.Encoded, q_rot: torch.Tensor, k: int, m: int,
             allow: Optional[Allowlist]) -> Tuple[torch.Tensor, torch.Tensor]:
    live = None if allow is None else allow.mask_on(enc.device)
    proxy = binary.coarse_scan_stage(q_rot, enc.ccodes, kind=enc.coarse)
    cand = binary.survivor_topk_stage(proxy, live, m=m)
    scores = binary.gathered_rescore_stage(q_rot, enc.packed, enc.qnorms, cand,
                                           bits=enc.bits, metric=enc.metric,
                                           n4_dims=enc.n4_dims)
    vals, sel = topk(scores, k)
    return vals, torch.gather(cand, 1, sel).long()


def search_backend(
    backend: bf_mod.BruteForceIndex,
    queries,
    k: int,
    *,
    allow: Optional[Allowlist] = None,
    rescore_mult: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [b, k] f32, external ids [b, k] uint64), both numpy on the host.

    Exactly ``k`` columns always; slots with no admissible row carry
    SENTINEL_ID and a NEG score.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    knobs = resolve_knobs(backend, k, rescore_mult=rescore_mult)
    enc = backend.enc
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=enc.device))
    if q.shape[-1] != enc.dim:
        raise ValueError(f"queries have dim {q.shape[-1]}, the index has {enc.dim}")
    if allow is not None and allow.mask.shape[0] != enc.n:
        raise ValueError(f"allowlist mask covers {allow.mask.shape[0]} rows but the index "
                         f"has {enc.n}; build it from the index ids")

    q_rot = qz.encode_query(q, enc)
    if knobs:
        vals, pos = _cascade(enc, q_rot, k, knobs["rescore_mult"] * k, allow)
    else:
        vals, pos = _full_scan(enc, q_rot, k, allow)
    pos = torch.where(vals > float(NEG), pos, -1)
    return vals.cpu().numpy(), seg.rows_to_ids(pos.cpu().numpy(), backend.ids)
