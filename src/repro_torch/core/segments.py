"""Segmented mutable corpus lifecycle (counterpart of ``repro/core/segments.py``;
DESIGN.md §6).

A ``MonaVec`` is a sequence of immutable quantized segments plus a deletion
bitmap per segment:

* segment 0 is the backend ``MonaVec.build`` made, quantized under the root
  seed;
* ``add(vectors, ids)`` quantizes a new segment through the same RHDH +
  Lloyd-Max pipeline, under a seed derived from (root seed, ordinal) by
  ``derive_segment_seed``, so replaying an op sequence reproduces the same
  packed bytes;
* ``delete(ids)`` never rewrites codes: it sets tombstone bits;
* ``compact()`` rewrites the live rows into one fresh segment 0 (codes ->
  rotated space -> inverse RHDH -> re-encode under the root seed).

Search scans every segment and masks tombstoned and disallowed rows to NEG
before any ranking (``live_mask``, one [n_total] mask that the engine takes
as an input of the plan), so "exactly min(k, live and allowed) real
results" survives mutation.  Codes, norms and coarse codes live on the
index's device; ids and tombstones stay numpy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import quantize as qz
from .allowlist import NEG, Allowlist
from .rhdh import rhdh_inverse
from .scoring import topk
from .standardize import L2

#: "No result" external id, the sentinel of every search path.
SENTINEL_ID = np.uint64(0xFFFFFFFFFFFFFFFF)

#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("merge_stage",)

_MASK64 = 0xFFFFFFFFFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15


def derive_segment_seed(root_seed: int, ordinal: int) -> int:
    """The RHDH seed of segment ``ordinal``: the root seed for ordinal 0 (a
    never-mutated index keeps the pre-segment bytes), else the splitmix64
    finalizer of ``root + golden * ordinal`` on 64-bit Python ints."""
    if ordinal == 0:
        return root_seed & _MASK64
    z = (root_seed + _GOLDEN * ordinal) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass
class Segment:
    """One immutable quantized block and its (mutable) deletion bitmap."""

    enc: qz.Encoded
    ids: np.ndarray                  # [n] u64 external ids
    tombs: np.ndarray                # [n] bool, True = deleted

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.n - self.tombs.sum())


@dataclasses.dataclass
class SegmentedState:
    """The mutation state of a MonaVec: the base segment's tombstones and
    the extra segments ``add()`` appended."""

    base_tombs: np.ndarray                       # [base_n] bool
    extras: List[Segment] = dataclasses.field(default_factory=list)
    next_ordinal: int = 1                        # ordinal of the next add()

    @staticmethod
    def fresh(base_n: int) -> "SegmentedState":
        return SegmentedState(base_tombs=np.zeros(base_n, dtype=bool))

    @property
    def is_static(self) -> bool:
        """No extra segment and nothing tombstoned: the index saves as v6/v7
        (or static v10) and searches as a build-once index."""
        return not self.extras and not self.base_tombs.any()


# ---------------------------------------------------------------------------
# Segment encoding: the add() and compact() quantization path.
# ---------------------------------------------------------------------------

def encode_segment(vectors: torch.Tensor, base: qz.Encoded, seed: int) -> qz.Encoded:
    """Quantize a new segment under the base segment's configuration
    (metric, bit mode, std, v7 permutation, pinned ``n4_dims``, coarse-code
    kind) and its own seed, on the device ``vectors`` lie on."""
    if base.bits in (2, 4):
        enc = qz.encode(vectors, metric=base.metric, seed=seed, bits=base.bits, std=base.std)
    else:
        enc = qz.encode_mixed(vectors, metric=base.metric, seed=seed, std=base.std,
                              perm=base.perm, n4_dims=base.n4_dims)
    if base.coarse is not None:
        from . import binary
        enc = binary.attach_coarse(enc, base.coarse)
    return enc


def reconstruct_vectors(enc: qz.Encoded) -> torch.Tensor:
    """Codes -> approximate input-space f32 rows [n, d] on the codes' device.

    Dequantize to rotated space, invert the unnormalized RHDH (Z = H D x, so
    x = D H Z / d'), then undo the metric preparation: L2 standardization is
    inverted; cosine preparation loses the magnitude, which cosine scoring
    never used; dot preparation is the identity.  A pure function of the
    codes, so compaction is deterministic.
    """
    deq = qz.decode(enc)                               # [n, d'] rotated f32
    x = rhdh_inverse(deq, enc.seed, enc.dim) * np.float32(1.0 / np.sqrt(deq.shape[-1]))
    if enc.metric == L2 and enc.std is not None:
        x = enc.std.inverse(x)
    return x


def reconstruct_rows(enc: qz.Encoded, rows: np.ndarray) -> torch.Tensor:
    """``reconstruct_vectors`` of a row subset (rows decode independently)."""
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64)).to(enc.device)
    sub = dataclasses.replace(enc, packed=enc.packed[idx], qnorms=enc.qnorms[idx],
                              ccodes=None if enc.ccodes is None else enc.ccodes[idx])
    return reconstruct_vectors(sub)


# ---------------------------------------------------------------------------
# Segmented search.
# ---------------------------------------------------------------------------

def rows_to_ids(rows: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Map row positions to external ids; negative rows -> SENTINEL_ID."""
    out = ids[np.maximum(rows, 0)].copy()
    out[rows < 0] = SENTINEL_ID
    return out


def _split_allow_mask(allow: Optional[Allowlist], base_n: int, extras: Sequence[Segment]
                      ) -> Tuple[Optional[np.ndarray], List[Optional[np.ndarray]]]:
    """Slice an allowlist over ``MonaVec.ids`` (every segment's ids,
    tombstoned rows included) into per-segment masks."""
    if allow is None:
        return None, [None] * len(extras)
    mask = np.asarray(allow.mask, dtype=bool)
    total = base_n + sum(s.n for s in extras)
    if mask.shape[0] != total:
        raise ValueError(f"allowlist mask covers {mask.shape[0]} rows but the segmented "
                         f"index has {total}; build it from MonaVec.ids")
    out, off = [], base_n
    for s in extras:
        out.append(mask[off: off + s.n])
        off += s.n
    return mask[:base_n], out


def live_mask(state: SegmentedState, allow: Optional[Allowlist], base_n: int) -> np.ndarray:
    """The [n_total] bool mask of live and allowed rows in segment order."""
    base_mask, extra_masks = _split_allow_mask(allow, base_n, state.extras)
    cols = [~state.base_tombs if base_mask is None else (~state.base_tombs & base_mask)]
    for s, am in zip(state.extras, extra_masks):
        cols.append(~s.tombs if am is None else (~s.tombs & am))
    return np.concatenate(cols) if len(cols) > 1 else cols[0]


def merge_stage(main_vals: torch.Tensor, main_pos: torch.Tensor, side_scores: torch.Tensor,
                base_n: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a candidate-set scan's top-k (IVF/HNSW: ``main_vals`` [b, k]
    with NEG sentinels, ``main_pos`` [b, k] base rows with -1) with the
    extra segments' masked side-scan scores [b, n_extra].

    Main candidates take the lower columns, so the stable top-k breaks
    score ties to the base segment first, then the extras in row order, as
    the concatenated-row-order oracle does.  Returns (vals [b, k'], rows in
    concatenated order [b, k'], -1 where no row is admissible), k' = min(k,
    k + n_extra).
    """
    b, n_extra = side_scores.shape
    side_pos = (base_n + torch.arange(n_extra, dtype=main_pos.dtype,
                                      device=main_pos.device))[None, :].expand(b, n_extra)
    cand_scores = torch.cat([main_vals, side_scores], dim=1)
    cand_pos = torch.cat([main_pos, side_pos], dim=1)
    vals, sel = topk(cand_scores, min(k, cand_scores.shape[1]))
    pos = torch.gather(cand_pos, 1, sel)
    return vals, torch.where(vals > float(NEG), pos, -1)
