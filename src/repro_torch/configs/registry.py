"""Architecture registry (counterpart of ``repro/configs/registry.py``):
``--arch <id>`` resolves here.

Each Arch bundles the exact full config, a reduced smoke config and its
input-shape set, equal field by field to the reference's entry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train|prefill|decode|full_graph|minibatch|graphs|recsys_train|recsys_serve|retrieval
    dims: Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str                  # lm|gnn|recsys|retrieval
    make_config: Callable[[], object]
    make_smoke: Callable[[], object]
    shapes: Tuple[ShapeSpec, ...]
    skips: Mapping[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


_REGISTRY: Dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    assert arch.arch_id not in _REGISTRY, f"duplicate arch {arch.arch_id}"
    _REGISTRY[arch.arch_id] = arch
    return arch


def get(arch_id: str) -> Arch:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}") from None


def all_archs() -> Dict[str, Arch]:
    return dict(_REGISTRY)


def cells(include_skipped: bool = False):
    """Every (arch, shape) dry-run cell, optionally including documented skips."""
    out = []
    for arch in _REGISTRY.values():
        for s in arch.shapes:
            if s.name in arch.skips and not include_skipped:
                continue
            out.append((arch, s))
    return out


# Shared LM shape set (assigned): seq_len x global_batch.
LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    ShapeSpec("minibatch_lg", "minibatch",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout0": 15, "fanout1": 10, "d_feat": 602, "n_classes": 41}),
    ShapeSpec("ogb_products", "full_graph",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_classes": 47}),
    ShapeSpec("molecule", "graphs",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
               "n_classes": 2}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", {"batch": 65536}),
    ShapeSpec("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)
