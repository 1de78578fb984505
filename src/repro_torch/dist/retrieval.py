"""Sharded top-k retrieval: the MonaVec scan over a device mesh (counterpart
of ``repro/dist/retrieval.py``; DESIGN.md §3).

Decomposition (the standard MIPS-over-partitions scheme):

  1. the corpus (packed codes + qnorms) is split into contiguous row shards,
     each on its mesh device (``partition.py``);
  2. every shard scores its rows against the rotated queries with the same
     kernels the single-device scan uses (``kernels.ops``: B1/B3 on the
     card), adjusts by metric, masks padding rows and inadmissible rows to
     -inf, and takes a local stable top-k;
  3. the local winners, offset to global ids, are concatenated in shard
     order on the first device and re-selected by a stable top-k.

Shards are contiguous and both selections stable (``scoring.topk``: lower
index wins ties), so the merged (scores, ids) equal the single-device scan's
on any mesh: a row's score comes from the same kernel on the same bytes, and
sharding only removes rows from a launch, never re-associates a row's sum.

The reference builds these as ``shard_map`` programs.  Here a factory
returns a ``ShardScan``: its ``local`` is one shard's stage on that shard's
device, its ``merge`` the cross-shard selection, and calling it runs the
whole program over full logical arrays (pad, place each shard, local stages,
merge), as the reference's returned function does.  The engine
(``engine.plan.search_sharded``) runs the same ``local`` and ``merge``
inside its CUDA graphs.  ``scan_topk_pjit`` / ``scan_topk_f32`` are the
single-array references, named as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core import binary as bin_mod
from ..core.scoring import adjust_scores, score_f32, topk
from ..kernels.ops import score_raw

from .partition import shard_rows, shard_sizes

_INF = float("inf")

#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("make_scan_topk_shardmap", "make_cascade_topk_shardmap")


# ---------------------------------------------------------------------------
# Single-logical-array references.
# ---------------------------------------------------------------------------

def scan_topk_pjit(q_rot: torch.Tensor, packed: torch.Tensor, qnorms: torch.Tensor, *,
                   metric: str = "cosine", k: int = 10, bits: int = 4,
                   n4_dims: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference quantized scan over one array: (scores [b, k], indices [b, k])."""
    raw = score_raw(packed, q_rot, bits=bits, n4_dims=n4_dims)
    return topk(adjust_scores(raw, qnorms, metric), k)


def scan_topk_f32(queries: torch.Tensor, corpus: torch.Tensor, *, metric: str = "dot",
                  k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 scan reference (the accuracy ceiling): (scores, indices)."""
    return topk(score_f32(queries, corpus, metric), k)


# ---------------------------------------------------------------------------
# One shard's local stage, and the merge.
# ---------------------------------------------------------------------------

def _merge_topk(vals: Sequence[torch.Tensor], gids: Sequence[torch.Tensor], k: int):
    """Concatenate per-shard candidates in shard order on the first shard's
    device and take a stable top-k: shard order is global-id order, so ties
    resolve as in the single-device scan."""
    dev = vals[0].device
    vg = torch.cat([v.to(dev) for v in vals], dim=1)          # [b, S * k_local]
    gg = torch.cat([g.to(dev) for g in gids], dim=1)
    vv, mi = topk(vg, k)
    return vv, torch.gather(gg, 1, mi)


def _pad_live(per: int, valid: int, mask: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """A shard's admissible rows: real rows (the padding sentinel) AND
    ``mask``; None when every row is admissible."""
    if mask is None and valid == per:
        return None
    live = torch.arange(per, device=device) < valid
    return live if mask is None else live & mask


def scan_local(q_rot, packed, qnorms, *, gid0: int, valid: int, k_local: int, metric: str,
               bits: int, n4_dims: int, mask: Optional[torch.Tensor] = None):
    """One shard's full scan: scores of its rows, padding rows (local row
    >= ``valid``) and rows ``mask`` rejects at -inf, the stable top
    ``k_local`` as (scores, global ids)."""
    s = adjust_scores(score_raw(packed, q_rot, bits=bits, n4_dims=n4_dims), qnorms, metric)
    live = _pad_live(int(packed.shape[0]), valid, mask, s.device)
    if live is not None:
        s = s.masked_fill(~live[None, :], -_INF)
    v, li = topk(s, k_local)
    return v, li + gid0


def cascade_local(q_rot, packed, qnorms, ccodes, *, gid0: int, valid: int, m_local: int,
                  k_local: int, kind: str, metric: str, bits: int, n4_dims: int,
                  mask: Optional[torch.Tensor] = None):
    """One shard's binarized cascade: coarse proxy, survivor top-m over its
    admissible rows (padding and ``mask`` applied before selection, so a
    filtered shard spends its whole budget on admissible rows), gathered
    rescore, local stable top-k; dead survivor slots are -inf with id 0."""
    live = _pad_live(int(packed.shape[0]), valid, mask, q_rot.device)
    proxy = bin_mod.coarse_scan_stage(q_rot, ccodes, kind=kind)
    cand = bin_mod.survivor_topk_stage(proxy, live, m=m_local)
    s = bin_mod.gathered_rescore_stage(q_rot, packed, qnorms, cand, bits=bits, metric=metric,
                                       n4_dims=n4_dims)
    s = torch.where(cand >= 0, s, -_INF)                       # dead survivors
    v, si = topk(s, k_local)
    wrow = torch.gather(cand, 1, si).long()
    return v, torch.where(wrow >= 0, wrow + gid0, 0)


@dataclasses.dataclass(frozen=True)
class ShardScan:
    """A sharded scan (plain, or the cascade when ``kind`` is set) over
    ``n_shards`` contiguous shards at k, in the torch form of the
    reference's ``shard_map`` program."""

    devices: tuple                 # each shard's device, in shard order
    metric: str
    k: int
    bits: int
    n4_dims: int
    n_valid: Optional[int]
    with_mask: bool
    kind: Optional[str] = None     # the cascade's coarse kind; None: the full scan
    m: int = 0                     # the cascade's survivors per shard (before min(m, per))

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def local(self, shard: int, n: int, q_rot, packed, qnorms, ccodes=None, mask=None):
        """Shard ``shard``'s stage over its ``per`` rows of an n-row corpus:
        (scores, global ids) [b, k_local], inadmissible slots -inf."""
        per = int(packed.shape[0])
        gid0 = shard * per
        valid = max(0, min(per, n - gid0))
        common = dict(gid0=gid0, valid=valid, metric=self.metric, bits=self.bits,
                      n4_dims=self.n4_dims, mask=mask)
        if self.kind is None:
            return scan_local(q_rot, packed, qnorms, k_local=min(self.k, per), **common)
        m_local = min(self.m, per)
        return cascade_local(q_rot, packed, qnorms, ccodes, m_local=m_local,
                             k_local=min(self.k, per, m_local), kind=self.kind, **common)

    def merge(self, vals: Sequence[torch.Tensor], gids: Sequence[torch.Tensor]):
        return _merge_topk(vals, gids, self.k)

    def __call__(self, q_rot, packed, qnorms, *rest):
        """The whole program over full logical arrays: ``(q_rot, packed,
        qnorms[, ccodes][, mask])`` -> (scores [b, k], global ids [b, k]).
        The arrays are padded and each shard placed on its device (a
        ``ShardedMonaVec``'s arrays are already padded: pass ``n_valid``)."""
        rest = list(rest)
        ccodes = rest.pop(0) if self.kind is not None else None
        mask = rest.pop(0) if self.with_mask else None
        n = int(packed.shape[0]) if self.n_valid is None else self.n_valid
        none = (None,) * self.n_shards
        parts = zip(shard_rows(self.devices, packed), shard_rows(self.devices, qnorms, 1.0),
                    none if ccodes is None else shard_rows(self.devices, ccodes),
                    none if mask is None else shard_rows(self.devices, mask, False))
        vals, gids = [], []
        for s, (dev, (pk, qn, cc, mk)) in enumerate(zip(self.devices, parts)):
            v, g = self.local(s, n, q_rot.to(dev), pk, qn, cc, mk)
            vals.append(v)
            gids.append(g)
        return self.merge(vals, gids)


# ---------------------------------------------------------------------------
# The factories (named as the reference's shard_map factories).
# ---------------------------------------------------------------------------

def make_scan_topk_shardmap(mesh, *, metric: str = "cosine", k: int = 10, bits: int = 4,
                            n4_dims: int = 0, n_valid: Optional[int] = None,
                            with_mask: bool = False) -> ShardScan:
    """The sharded full scan: ``fn(q_rot, packed, qnorms[, mask]) -> (scores
    [b, k], global ids [b, k])``.  ``n_valid`` is the true row count of
    already-padded arrays; ``with_mask`` adds an [n] boolean admissibility
    mask, applied with the padding sentinel before every local top-k (slots
    with no admissible row come back -inf for the caller to convert).
    Kernels dispatch by the shards' device, so the reference's
    ``use_kernel`` / ``interpret`` have no counterpart."""
    return ShardScan(devices=tuple(mesh.devices), metric=metric, k=k, bits=bits,
                     n4_dims=n4_dims, n_valid=n_valid, with_mask=with_mask)


def make_cascade_topk_shardmap(mesh, *, metric: str = "cosine", k: int = 10, bits: int = 4,
                               n4_dims: int = 0, n_valid: Optional[int] = None,
                               with_mask: bool = False, kind: str = bin_mod.SIGN,
                               m: int = 320) -> ShardScan:
    """The binarized-cascade variant (DESIGN.md §11): ``fn(q_rot, packed,
    qnorms, ccodes[, mask])``.  Each shard runs the whole cascade on its rows
    (proxy, survivor top-``min(m, per)``, gathered rescore, local top-k),
    then the same merge as the full scan."""
    return ShardScan(devices=tuple(mesh.devices), metric=metric, k=k, bits=bits,
                     n4_dims=n4_dims, n_valid=n_valid, with_mask=with_mask, kind=kind, m=m)


def make_scan_topk_f32_shardmap(mesh, *, metric: str = "dot", k: int = 10):
    """The exact f32 variant: ``fn(queries, corpus)``.  Every ``score_f32``
    metric is row-local on the corpus side, so sharding rows never changes a
    score."""
    devices = tuple(mesh.devices)
    n_shards = len(devices)

    def call(queries: torch.Tensor, corpus: torch.Tensor):
        n = int(corpus.shape[0])
        per, _ = shard_sizes(n, n_shards)
        shards = shard_rows(devices, corpus)
        vals, gids = [], []
        for s, (dev, c) in enumerate(zip(devices, shards)):
            sc = score_f32(queries.to(dev), c, metric)
            valid = max(0, min(per, n - s * per))
            if valid < per:
                sc[:, valid:] = -_INF
            v, li = topk(sc, min(k, per))
            vals.append(v)
            gids.append(li + s * per)
        return _merge_topk(vals, gids, k)

    return call
