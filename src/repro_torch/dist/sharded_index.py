"""ShardedMonaVec: the MonaVec facade over a device mesh (counterpart of
``repro/dist/sharded_index.py``).

Wraps an encoded corpus (from a built MonaVec or a loaded .mvec file), pads
it to the shard grid, places each contiguous row block on its device, and
serves the same ``search(queries, k)`` contract through the sharded scan,
with results identical to the single-device index (DESIGN.md §3):

    idx = MonaVec.build(vectors, metric="cosine")
    sharded = idx.shard()                 # one shard per local device
    scores, ids = sharded.search(queries, k=10)

Every search runs through ``engine.search_sharded``: on the card the
captured CUDA graphs of its plan, which live here with the shards (``graphs``,
one per plan key), as a backend's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import predicate as pred
from ..core import quantize as qz
from ..core.bruteforce import BruteForceIndex
from ..core.metadata import MetaStore
from ..launch.mesh import Mesh, make_local_mesh

from .partition import place_sharded, shard_rows, shard_sizes


@dataclasses.dataclass(frozen=True)
class Shard:
    """One contiguous row block on its device: global rows [lo, hi) of the
    corpus, padded to ``per`` rows."""

    packed: torch.Tensor            # [per, bytes] uint8
    qnorms: torch.Tensor            # [per] f32, padding rows 1.0
    ccodes: Optional[torch.Tensor]  # [per, code bytes] uint8, or None
    lo: int
    hi: int

    @property
    def device(self) -> torch.device:
        return self.packed.device


@dataclasses.dataclass
class ShardedMonaVec:
    # The encoding's header (seed, metric, bits, dims, std, permutation,
    # coarse kind).  Its tensors are shape-only stand-ins on the "meta"
    # device for the padded [n_pad, ...] corpus: the rows live in ``shards``.
    enc: qz.Encoded
    shards: Tuple[Shard, ...]
    ids: np.ndarray                 # [n] external ids (unpadded), on the host
    mesh: Mesh
    n: int                          # true (unpadded) corpus rows
    meta: Optional[MetaStore] = None   # metadata columns (carried from MonaVec)
    tuned: Optional[object] = None     # tune.TuneResult (carried over)
    # The permutation index on each of the mesh's distinct devices (v7), in
    # ``mesh.groups`` order; None without a permutation.
    perms: tuple = ()
    # On the card: the engine's captured CUDA graphs over these shards, by
    # plan key.  They hold the shards' tensors and die with the index.
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    # -- construction ------------------------------------------------------

    @staticmethod
    def shard(index, mesh: Optional[Mesh] = None) -> "ShardedMonaVec":
        """Shard a MonaVec / BruteForceIndex / Encoded over ``mesh`` (default:
        one shard per local device of the index's device type).

        Only the BruteForce backend shards: it is the paper's deterministic
        core and the only scan whose partition merge is exact by construction
        (IVF/HNSW traversals are pointer-chasing, not row scans).  A mutated
        MonaVec raises, whichever way it comes here (a loaded v8 file too):
        its base segment alone would drop the added rows and serve the
        tombstoned ones.
        """
        from ..core.api import MonaVec
        meta = tuned = None
        if isinstance(index, MonaVec):
            if not index.mut.is_static:
                raise TypeError("shard() requires an unmutated index — compact() first")
            meta = index.meta
            tuned = index.tuned
            index = index.backend
        if isinstance(index, BruteForceIndex):
            enc, ids = index.enc, index.ids
        elif isinstance(index, qz.Encoded):
            enc, ids = index, np.arange(index.n, dtype=np.uint64)
        else:
            raise TypeError(
                f"cannot shard a {type(index).__name__}: only the BruteForce "
                "scan has an exact cross-shard merge")
        if mesh is None:
            mesh = make_local_mesh(enc.device.type)
        packed, qnorms, n = place_sharded(mesh, enc.packed, enc.qnorms)
        # Coarse codes shard row-contiguously beside the packed bytes (zero
        # pad rows: the scan masks them before any selection).
        ccodes = ((None,) * mesh.size if enc.ccodes is None
                  else shard_rows(mesh.devices, enc.ccodes))
        per, n_pad = shard_sizes(n, mesh.size)
        shards = tuple(Shard(packed=p, qnorms=q, ccodes=c, lo=min(s * per, n),
                             hi=min((s + 1) * per, n))
                       for s, (p, q, c) in enumerate(zip(packed, qnorms, ccodes)))
        perms = () if enc.perm is None else tuple(
            torch.as_tensor(enc.perm, dtype=torch.long).to(dev) for dev, _ in mesh.groups)

        def stand_in(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            return None if t is None else torch.empty((n_pad,) + tuple(t.shape[1:]),
                                                      dtype=t.dtype, device="meta")

        header = dataclasses.replace(enc, packed=stand_in(enc.packed),
                                     qnorms=stand_in(enc.qnorms), ccodes=stand_in(enc.ccodes))
        return ShardedMonaVec(enc=header, shards=shards, ids=np.asarray(ids), mesh=mesh, n=n,
                              meta=meta, tuned=tuned, perms=perms)

    @staticmethod
    def load(path: str, mesh: Optional[Mesh] = None,
             device: torch.device | str = "cuda") -> "ShardedMonaVec":
        """Load a .mvec file and shard it over ``mesh`` (default: one shard
        per local device of ``device``)."""
        from ..core.api import MonaVec
        if mesh is None:
            mesh = make_local_mesh(device)
        return ShardedMonaVec.shard(MonaVec.load(path, device=mesh.devices[0]), mesh)

    # -- the engine's view -------------------------------------------------

    def bound(self, with_codes: bool) -> tuple:
        """The tensors a sharded plan reads: (packed, qnorms[, ccodes]) per
        shard in shard order, then the permutation on each distinct device
        (None each without one)."""
        out = []
        for s in self.shards:
            out.extend((s.packed, s.qnorms, s.ccodes) if with_codes else (s.packed, s.qnorms))
        return tuple(out) + (self.perms or (None,) * len(self.mesh.groups))

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int = 10, *, where: Optional[pred.Predicate] = None,
               where_mask=None, rescore_mult: Optional[int] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [b, k], external ids [b, k]): the same contract and the
        same results as the single-device BruteForce search, through a cached
        plan of the engine (bucketed batches, the shared counters, exactly
        ``k`` columns with SENTINEL_ID / NEG padding when k exceeds the
        corpus).

        ``where=`` filters through the index's metadata columns: the
        predicate is evaluated on the host against the exact values (the
        oracle the engine's compiled stage is held to), and the row mask is
        applied in every shard before its local top-k.  ``where_mask=`` is a
        precomputed [n] mask; the two compose (AND)."""
        from ..engine.plan import search_sharded
        n_shards = self.mesh.size
        obs.inc("dist.requests", shards=n_shards)
        with obs.timed_span("sharded_search", histogram="dist.search_us",
                            labels={"shards": n_shards},
                            attrs={"shards": n_shards, "n": self.n}):
            mask = None if where_mask is None else np.asarray(where_mask, bool)
            if where is not None:
                if self.meta is None or not self.meta:
                    raise ValueError("where= requires an index built with metadata columns")
                if self.meta.n_rows != self.n:
                    raise ValueError(f"metadata has {self.meta.n_rows} rows but the index "
                                     f"has {self.n}")
                with obs.timed_span("predicate_eval", histogram="dist.predicate_us"):
                    pred.validate(where, self.meta)
                    pm = pred.evaluate(where, self.meta)
                mask = pm if mask is None else mask & pm
            self._trace_shards()
            return search_sharded(self, queries, k, where_mask=mask, rescore_mult=rescore_mult,
                                  tuned=self.tuned)

    def _trace_shards(self) -> None:
        """Under an active QueryTrace, one structural span per shard (row
        range and device): placement metadata, not per-device wall time."""
        tr = obs.current_trace()
        if tr is None:
            return
        for i, s in enumerate(self.shards):
            sp = tr.push(f"shard:{i}", rows=s.hi - s.lo, device=str(s.device))
            tr.pop(sp)

    def searcher(self, k: int = 10, *, where: Optional[pred.Predicate] = None, **knobs):
        """Bound search handle over the sharded scan (``engine.Searcher``);
        ``**knobs`` (e.g. ``rescore_mult=``) bind into every call."""
        from ..engine.plan import Searcher
        return Searcher(self, k=k, where=where, knobs=knobs)
