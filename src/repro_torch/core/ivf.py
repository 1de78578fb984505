"""IvfFlat backend (counterpart of ``repro/core/ivf.py``; paper §3.4.2):
metric-aware k-means and inverted lists.

The one opt-in trained component (paper Table 1): Lloyd's algorithm over the
corpus in rotated f32 space (the rotation is orthogonal, so the cluster
geometry is the input space's, and the probe shares the rotated query with
the packed scan).  Under cosine the centroids are L2-normalized after every
mean update; under dot and L2 they are raw means.  Deterministic: a seeded
greedy farthest-point init on the host (numpy, as the reference's), a fixed
number of iterations, first-index argmin / argmax.

Determinism on the card: the cluster sums are one product ``one_hot.T @
x`` (never ``index_add_`` / ``scatter_add_``, whose float atomics would
change bits from run to run, and two builds would then write different
``.mvec`` files), and the build's k-means products run with TF32 off
(``_f32_products``), whatever the caller's setting.  The probe's product
follows the process's setting, as every other product of the port does.

The probe scan runs over packed codes end to end: the CSR ``order`` and
``offsets`` are staged on the device once, at build and at load; a query's
candidates assemble as a vectorized ragged concatenation into a fixed
[b, max_cand] matrix (-1 tail) with a batched ``searchsorted``, and are
scored by ``ops.score_gathered`` (the B4 / B5 kernels on the card), with
the live mask applied before the top-k.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import quantize as qz
from .allowlist import NEG, Allowlist
from .rhdh import rhdh_apply
from .scoring import topk
from .standardize import COSINE, L2, prepare

_NEG = float(NEG)

#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("search_stage",)


@contextlib.contextmanager
def _f32_products():
    """Matrix products in full f32 (TF32 off) inside, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _assign(x: torch.Tensor, cents: torch.Tensor, metric: str) -> torch.Tensor:
    """Nearest centroid per row; argmin / argmax return the first index."""
    if metric == L2:
        d2 = (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * x @ cents.T
              + torch.sum(cents * cents, dim=1)[None, :])
        return torch.argmin(d2, dim=1)
    return torch.argmax(x @ cents.T, dim=1)


def _kmeans(x: torch.Tensor, init: torch.Tensor, *, n_clusters: int, metric: str,
            iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration Lloyd's; an empty cluster keeps its previous centroid."""
    cents = init
    with _f32_products():
        for _ in range(iters):
            a = _assign(x, cents, metric)
            one_hot = torch.nn.functional.one_hot(a, n_clusters).to(x.dtype)   # [n, k]
            sums = one_hot.T @ x                                               # [k, d]
            counts = torch.sum(one_hot, dim=0)[:, None]                        # [k, 1]
            means = sums / torch.clamp(counts, min=1.0)
            new = torch.where(counts > 0, means, cents)
            if metric == COSINE:
                new = new / torch.clamp(torch.linalg.vector_norm(new, dim=1, keepdim=True),
                                        min=1e-12)
            cents = new
        return cents, _assign(x, cents, metric)


def _seeded_init(x: np.ndarray, k: int, seed: int, metric: str) -> np.ndarray:
    """Deterministic farthest-point (greedy, k-means++-style) initialization
    on the host, the reference's numpy steps; the row norms are computed once
    (the same bytes the reference recomputes each step)."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    n = x.shape[0]
    first = int(rng.randint(n))
    chosen = [first]
    if metric == L2:
        d = np.sum((x - x[first]) ** 2, axis=1)
    else:
        norms = np.linalg.norm(x, axis=1)
        d = 1.0 - x @ x[first] / (norms * np.linalg.norm(x[first]) + 1e-12)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))  # greedy farthest, first index on ties
        chosen.append(nxt)
        if metric == L2:
            d = np.minimum(d, np.sum((x - x[nxt]) ** 2, axis=1))
        else:
            d = np.minimum(d, 1.0 - x @ x[nxt] / (norms * np.linalg.norm(x[nxt]) + 1e-12))
    return x[np.asarray(chosen)]


def probe_scores(q_rot: torch.Tensor, centroids: torch.Tensor, metric: str) -> torch.Tensor:
    """[b, nlist] centroid scores a query probes by (higher = nearer)."""
    cs = q_rot @ centroids.T
    if metric == L2:
        cs = cs - 0.5 * torch.sum(centroids * centroids, dim=1)[None, :]
    return cs


def candidates(probe: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
               width: int) -> torch.Tensor:
    """[b, width] candidate rows of the probed cells, in probe order, -1 after.

    Slot j of query b belongs to the probed cell whose cumulative length
    first exceeds j (a batched ``searchsorted``), at offset ``j - cum[cell-1]``
    in it: a ragged concatenation with no per-query loop and no padded
    [nlist, max_cell] table.
    """
    b, nprobe = probe.shape
    lens = (offsets[1:] - offsets[:-1])[probe]                       # [b, nprobe]
    cum = torch.cumsum(lens, dim=1)                                  # [b, nprobe]
    slot = torch.arange(width, dtype=offsets.dtype, device=offsets.device)
    cell = torch.searchsorted(cum, slot.expand(b, width).contiguous(), right=True)
    cell_c = torch.clamp(cell, max=nprobe - 1)
    prev = torch.where(cell_c > 0, torch.gather(cum, 1, torch.clamp(cell_c - 1, min=0)), 0)
    src = torch.gather(offsets[probe], 1, cell_c) + (slot[None, :] - prev)
    valid = slot[None, :] < cum[:, -1:]
    return torch.where(valid, order[torch.clamp(src, max=order.shape[0] - 1)], -1)


def search_stage(q_rot: torch.Tensor, centroids: torch.Tensor, order: torch.Tensor,
                 offsets: torch.Tensor, packed: torch.Tensor, qnorms: torch.Tensor,
                 allow_mask: Optional[torch.Tensor], *, k: int, nprobe: int, max_cand: int,
                 metric: str, bits: int, n4_dims: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe, gathered scan and pre-filtered top-k of the base segment: the
    plan stage the engine composes with the query rotation and the merge of
    extra segments.  ``max_cand`` (the sum of the ``nprobe`` largest cells)
    is part of the plan key, so the shapes are fixed.  Returns (vals [b, k],
    rows [b, k]); a slot with no admissible candidate is NEG / -1."""
    _, probe = topk(probe_scores(q_rot, centroids, metric), nprobe)    # [b, nprobe]
    cand = candidates(probe, order, offsets, max(max_cand, k))
    scores = ops.score_gathered(packed, q_rot, cand, bits=bits, n4_dims=n4_dims,
                                qnorms=qnorms, metric=metric, allow_mask=allow_mask)
    vals, pos = topk(scores, k)
    rows = torch.gather(cand, 1, pos)
    return vals, torch.where(vals > _NEG, rows, -1)


@dataclasses.dataclass
class IvfFlatIndex:
    enc: qz.Encoded
    ids: np.ndarray                 # [n] external ids, on the host
    centroids: torch.Tensor         # [nlist, d'] rotated f32, on the codes' device
    order: np.ndarray               # [n] int64 row permutation grouping the cells
    offsets: np.ndarray             # [nlist + 1] int64 CSR offsets into ``order``
    nlist: int
    # The CSR on the codes' device (int64), staged once per index, at build
    # and at load: the candidate assembly never copies it per search.
    order_t: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    offsets_t: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    # The engine's captured CUDA graphs over this index, by plan key (as
    # ``BruteForceIndex.graphs``: they live and die with the index).
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def __post_init__(self):
        dev = self.enc.device
        self.order = np.asarray(self.order, dtype=np.int64)
        self.offsets = np.asarray(self.offsets, dtype=np.int64)
        self.centroids = torch.as_tensor(self.centroids, dtype=torch.float32).to(dev)
        self.order_t = torch.from_numpy(self.order.copy()).to(dev)
        self.offsets_t = torch.from_numpy(self.offsets.copy()).to(dev)

    @staticmethod
    def build(vectors: torch.Tensor, *, ids: Optional[np.ndarray] = None,
              metric: str = COSINE, seed: int = 0x6D6F6E61, bits: int = 4, std=None,
              nlist: int = 64, train_iters: int = 25) -> "IvfFlatIndex":
        """Encode ``vectors`` and cluster their rotated rows, on their device."""
        n = vectors.shape[0]
        enc = qz.encode(vectors, metric=metric, seed=seed, bits=bits, std=std)
        rot = rhdh_apply(prepare(vectors.to(torch.float32), metric, std), seed,
                         normalized=False)
        init = torch.from_numpy(_seeded_init(rot.cpu().numpy(), nlist, seed, metric))
        cents, assign = _kmeans(rot, init.to(rot.device), n_clusters=nlist, metric=metric,
                                iters=train_iters)
        assign = assign.cpu().numpy()
        order = np.argsort(assign, kind="stable").astype(np.int64)
        counts = np.bincount(assign, minlength=nlist)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        if ids is None:
            ids = np.arange(n, dtype=np.uint64)
        return IvfFlatIndex(enc=enc, ids=np.asarray(ids, dtype=np.uint64), centroids=cents,
                            order=order, offsets=offsets, nlist=nlist)

    def max_candidates(self, nprobe: int) -> int:
        """Sum of the ``nprobe`` largest cell sizes: the fixed width of the
        candidate matrix (part of the engine's plan key)."""
        counts = self.offsets[1:] - self.offsets[:-1]
        return int(np.sort(counts)[::-1][:nprobe].sum())

    def search(self, queries, k: int, *, nprobe: int = 8, allow: Optional[Allowlist] = None,
               **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Probe the ``nprobe`` nearest cells and scan their rows, through
        the engine; always exactly ``k`` columns, a slot with no admissible
        candidate carrying SENTINEL_ID and a NEG score."""
        from ..engine.plan import search_backend
        return search_backend(self, None, queries, k, allow=allow, nprobe=nprobe, **kwargs)
