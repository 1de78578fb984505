"""The audit grid: drive the REAL engine over tiny indexes and capture every
stage through ``engine.plan.set_stage_observer`` (counterpart of
``repro/analysis/grid.py``).

The auditor never re-implements stage construction — it installs the
observer hook, runs ordinary ``MonaVec.search`` / ``ShardedMonaVec.search``
/ ``HybridIndex.search`` calls over a backend × metric × bits × lifecycle
grid (plus predicate, mixed-precision, sharded, cascade, hybrid and tuned
points), and audits exactly the functions and operands the plans ran.  Two
batch sizes straddle a bucket boundary (b=3 → bucket 8, b=12 → bucket 16)
so a full-scan product that merely COINCIDES with the 8-row chunk at the
small bucket cannot pass.

On the CPU every search runs its stages eagerly and reports each of them.
On the card a stage reports while its plan warms up before the capture (the
first search of each plan over each grid index); the replays run no Python.

Coverage is closed-loop (INV-STAGE-COVERAGE): every stage factory a module
exports through ``PLAN_STAGES`` must be witnessed by at least one capture,
otherwise the audit emits an ``uncovered-stage`` finding — a new stage
cannot ship outside the auditor's view.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .findings import Finding
from .invariants import annotate
from .op_audit import StageCapture

#: Tiny but structurally honest corpora: n is corpus-scale relative to every
#: structural dimension in play (d_pad=16, nlist=8, k=4 all < N_EXTRA), so
#: the full-scan-dot threshold (min per-segment rows) never collides with a
#: legitimate small product.
N_BASE = 48
N_EXTRA = 24
DIM = 16
K = 4
BATCHES = (3, 12)          # buckets 8 and 16


@dataclasses.dataclass(frozen=True)
class GridPoint:
    label: str
    index: str = "bruteforce"          # bruteforce | ivf | hnsw
    metric: str = "cosine"
    bits: int = 4
    lifecycle: str = "static"          # static | mutated
    where: bool = False                # compile a predicate mask stage
    sharded: bool = False
    hybrid: bool = False
    avg_bits: Optional[float] = None   # BF mixed-precision point
    coarse: Optional[str] = None       # sign | crumb: attach coarse codes
    rescore_mult: Optional[int] = None  # cascade rescore budget (r*k)
    tuned: bool = False                # autotune first; searches run tuned


def default_grid() -> Tuple[GridPoint, ...]:
    pts: List[GridPoint] = []
    for index in ("bruteforce", "ivf", "hnsw"):
        for metric, bits in (("cosine", 4), ("l2", 2), ("dot", 4)):
            pts.append(GridPoint(
                label=f"{index}/{metric}/b{bits}/static",
                index=index, metric=metric, bits=bits))
        pts.append(GridPoint(
            label=f"{index}/cosine/b4/mutated",
            index=index, lifecycle="mutated"))
    pts.append(GridPoint(label="bruteforce/cosine/mixed3.0/static",
                         avg_bits=3.0))
    pts.append(GridPoint(label="bruteforce/cosine/b4/static+where",
                         where=True))
    pts.append(GridPoint(label="ivf/l2/b4/mutated+where", index="ivf",
                         metric="l2", lifecycle="mutated", where=True))
    pts.append(GridPoint(label="sharded/cosine/b4/static", sharded=True))
    pts.append(GridPoint(label="hybrid/cosine/b4/static+where",
                         hybrid=True, where=True))
    # Binarized-cascade points: r*k=16 < every segment size (48 base / 24
    # extra), so the rescore_mult knob survives normalization and the
    # coarse_scan/survivor_topk/gathered_rescore stages run.
    pts.append(GridPoint(label="cascade-sign/cosine/b4/static",
                         coarse="sign", rescore_mult=4))
    pts.append(GridPoint(label="cascade-crumb/l2/b4/mutated+where",
                         coarse="crumb", rescore_mult=4,
                         lifecycle="mutated", where=True))
    pts.append(GridPoint(label="cascade-sign/sharded/cosine/b4/static",
                         coarse="sign", rescore_mult=4, sharded=True))
    # Autotuned point: the tuned boost curve makes every filtered search
    # consult the selectivity popcount stage, so the selectivity_popcount
    # capture is witnessed from a live tuned search.
    pts.append(GridPoint(label="ivf/cosine/b4/static+where+tuned",
                         index="ivf", where=True, tuned=True))
    return tuple(pts)


# ---------------------------------------------------------------------------
# Index construction (seeded; np.random.RandomState is the repo idiom).
# ---------------------------------------------------------------------------

def _vectors(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randn(n, DIM).astype(np.float32)


def _meta(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "cat": np.array(["red", "green", "blue"])[rng.randint(0, 3, n)],
        "price": rng.randint(0, 100, n).astype(np.int64),
    }


def _predicate() -> object:
    from ..core import predicate as pred
    return pred.And(pred.Ge("price", 10), pred.Ne("cat", "green"))


def _build_index(point: GridPoint, device: str) -> Any:
    from ..core.api import MonaVec
    kwargs: Dict[str, object] = {}
    if point.index == "ivf":
        kwargs = {"nlist": 8}
    elif point.index == "hnsw":
        kwargs = {"m": 4, "ef_construction": 16}
    if point.avg_bits is not None:
        kwargs["avg_bits"] = point.avg_bits
    meta = _meta(N_BASE, seed=7) if point.where else None
    idx = MonaVec.build(
        _vectors(N_BASE, seed=3), metric=point.metric, index=point.index,
        bits=point.bits, meta=meta, coarse=point.coarse, device=device, **kwargs)
    if point.lifecycle == "mutated":
        add_meta = _meta(N_EXTRA, seed=8) if point.where else None
        idx.add(_vectors(N_EXTRA, seed=4), meta=add_meta)
        idx.delete(list(idx.ids[2:10:2]))
    return idx


def _min_segment_rows(idx: Any) -> int:
    extras = idx.mut.extras if idx.mut is not None else []
    return min([int(idx.backend.enc.n)] + [int(s.n) for s in extras])


# ---------------------------------------------------------------------------
# Capture collection.
# ---------------------------------------------------------------------------

def _signature(x: Any) -> Any:
    """Shapes and dtypes of an operand tree (tensors, None, tuples, lists)."""
    if isinstance(x, (tuple, list)):
        return tuple(_signature(item) for item in x)
    if x is None:
        return None
    return (tuple(getattr(x, "shape", ())), str(getattr(x, "dtype", type(x).__name__)))


def _capture_key(cap: StageCapture) -> tuple:
    return (cap.backend, cap.stage, _signature(cap.args), cap.context.get("n_corpus"))


def collect_captures(
    points: Optional[Sequence[GridPoint]] = None,
    progress: Optional[Callable[[str], None]] = None,
    *,
    device: str = "cuda",
) -> List[StageCapture]:
    """Run the grid on ``device`` under the stage observer; returns
    deduplicated captures (one per distinct backend/stage/operand
    signature/n_corpus), each with every grid label that witnessed it."""
    from ..device import resolve_device
    from ..engine import plan as plan_mod

    dev = str(resolve_device(device))
    points = tuple(points if points is not None else default_grid())
    captures: List[StageCapture] = []
    current: Dict[str, object] = {}
    by_key: Dict[tuple, StageCapture] = {}

    def observer(kind: str, stage: str, fn: Callable[..., object],
                 args: Tuple[object, ...]) -> None:
        ctx = dict(current)
        label = str(ctx.get("label", ""))
        cap = StageCapture(backend=kind, stage=stage, fn=fn,
                           args=tuple(args), context=ctx)
        key = _capture_key(cap)
        prior = by_key.get(key)
        if prior is None:
            cap.context["labels"] = [label]
            by_key[key] = cap
            captures.append(cap)
        else:
            # Deduplicated, but keep every grid point that witnessed this
            # capture — coverage witnesses (e.g. the hybrid point) need it.
            labels = prior.context.setdefault("labels", [])
            if label not in labels:
                labels.append(label)

    prev = plan_mod.set_stage_observer(observer)
    try:
        for point in points:
            if progress:
                progress(point.label)
            current.clear()
            current["label"] = point.label
            _run_point(point, current, dev)
    finally:
        plan_mod.set_stage_observer(prev)
    return captures


def _run_point(point: GridPoint, current: Dict[str, object], device: str) -> None:
    where = _predicate() if point.where else None
    if point.hybrid:
        from ..core.hybrid import HybridIndex
        docs = [f"doc {i} alpha beta gamma"[: 12 + (i % 9)]
                for i in range(N_BASE)]
        hy = HybridIndex.build(
            _vectors(N_BASE, seed=3), docs,
            meta=_meta(N_BASE, seed=7) if point.where else None, device=device)
        current["n_corpus"] = int(hy.dense.enc.n)
        for b in BATCHES:
            q = _vectors(b, seed=11)
            hy.search(q, [f"alpha {i}" for i in range(b)], k=K, where=where)
        return

    idx = _build_index(point, device)
    current["n_corpus"] = _min_segment_rows(idx)
    if point.tuned:
        # Real autotune under the observer (its ladder-sweep searches are
        # ordinary plan executions over the same corpus); the count cache is
        # dropped first so the selectivity_popcount stage re-fires even when
        # the grid runs twice in one process.
        from ..tune import clear_caches
        clear_caches()
        idx.autotune(recall_target=0.9, k=K, n_queries=8)
    target = idx.shard() if point.sharded else idx
    kw = ({"rescore_mult": point.rescore_mult}
          if point.rescore_mult is not None else {})
    for b in BATCHES:
        q = _vectors(b, seed=11)
        target.search(q, k=K, where=where, **kw)


# ---------------------------------------------------------------------------
# PLAN_STAGES coverage (INV-STAGE-COVERAGE).
# ---------------------------------------------------------------------------

STAGE_MODULES = (
    "repro_torch.core.bruteforce",
    "repro_torch.core.ivf",
    "repro_torch.core.hnsw",
    "repro_torch.core.segments",
    "repro_torch.core.predicate",
    "repro_torch.core.binary",
    "repro_torch.dist.retrieval",
    "repro_torch.engine.fusion",
    "repro_torch.tune.selectivity",
)


def _coverage_witnesses() -> Dict[str, Callable[[Sequence[StageCapture]], bool]]:
    """How each exported stage factory proves it was captured."""
    def by_stage(
        stage: str, backend: Optional[str] = None,
    ) -> Callable[[Sequence[StageCapture]], bool]:
        def pred(caps: Sequence[StageCapture]) -> bool:
            return any(c.stage == stage
                       and (backend is None or c.backend == backend)
                       for c in caps)
        return pred

    def hybrid_point(caps: Sequence[StageCapture]) -> bool:
        # fusion.search_hybrid's dense channel is an ordinary plan; proof of
        # coverage is any stage witnessed while a hybrid grid point ran.
        return any(str(label).startswith("hybrid")
                   for c in caps for label in c.context.get("labels", ()))

    return {
        "repro_torch.core.bruteforce:scan_stage": by_stage("scan"),
        "repro_torch.core.ivf:search_stage": by_stage("main", "IvfFlatIndex"),
        "repro_torch.core.hnsw:search_stage": by_stage("main", "HnswIndex"),
        "repro_torch.core.segments:merge_stage": by_stage("merge"),
        "repro_torch.core.predicate:build_stage_fn": by_stage("predicate_mask"),
        "repro_torch.core.binary:coarse_scan_stage": by_stage("coarse_scan"),
        "repro_torch.core.binary:survivor_topk_stage": by_stage("survivor_topk"),
        "repro_torch.core.binary:gathered_rescore_stage":
            by_stage("gathered_rescore"),
        "repro_torch.dist.retrieval:make_scan_topk_shardmap":
            by_stage("shard_scan", "ShardedMonaVec"),
        "repro_torch.dist.retrieval:make_cascade_topk_shardmap":
            by_stage("cascade_shard_scan", "ShardedMonaVec"),
        "repro_torch.engine.fusion:search_hybrid": hybrid_point,
        "repro_torch.tune.selectivity:make_popcount_fn":
            by_stage("selectivity_popcount"),
    }


def coverage_findings(captures: Sequence[StageCapture]) -> List[Finding]:
    """Every PLAN_STAGES export must be witnessed; an export the auditor
    does not know how to witness is ALSO a finding (teach grid.py first)."""
    witnesses = _coverage_witnesses()
    found: List[Finding] = []
    for mod_name in STAGE_MODULES:
        mod = importlib.import_module(mod_name)
        for factory in getattr(mod, "PLAN_STAGES", ()):
            key = f"{mod_name}:{factory}"
            witness = witnesses.get(key)
            if witness is None:
                found.append(annotate(Finding(
                    check="uncovered-stage", site=key,
                    detail=(f"{key} is exported via PLAN_STAGES but the "
                            f"audit grid has no witness for it — add a "
                            f"grid point/witness in analysis/grid.py"),
                    signature=("uncovered-stage", "no-witness", key))))
            elif not witness(captures):
                found.append(annotate(Finding(
                    check="uncovered-stage", site=key,
                    detail=(f"{key} was never captured by the audit grid "
                            f"run — its stage factory is outside the "
                            f"auditor's view"),
                    signature=("uncovered-stage", "not-captured", key))))
    return found


def grid_launches(captures: Sequence[StageCapture]) -> Dict[str, int]:
    """Kernel launches of every audited stage rerun, summed by kernel id
    (``op_audit.audit_captures`` fills each capture's ``launches``)."""
    total: Dict[str, int] = {}
    for cap in captures:
        for kid, n in cap.context.get("launches", {}).items():
            total[kid] = total.get(kid, 0) + int(n)
    return dict(sorted(total.items()))


__all__ = ["BATCHES", "DIM", "GridPoint", "K", "N_BASE", "N_EXTRA", "STAGE_MODULES",
           "collect_captures", "coverage_findings", "default_grid", "grid_launches"]
