"""Assigned GNN architecture: gin-tu [arXiv:1810.00826]."""

from __future__ import annotations

from ..models.gnn import GINConfig

from .registry import GNN_SHAPES, Arch, register


def gin_tu() -> GINConfig:
    # n_layers=5 d_hidden=64 aggregator=sum eps=learnable.  d_feat/n_classes
    # are per-shape (cora-like / reddit-like / products-like / molecule);
    # the dry-run instantiates the right head per shape spec.
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64,
                     d_feat=1433, n_classes=7)


def gin_smoke() -> GINConfig:
    return GINConfig(name="gin-smoke", n_layers=3, d_hidden=16, d_feat=8,
                     n_classes=3)


register(Arch(
    arch_id="gin-tu", family="gnn", make_config=gin_tu, make_smoke=gin_smoke,
    shapes=GNN_SHAPES,
    notes=("The paper's ANN-scoring technique is inapplicable to message "
           "passing itself (DESIGN.md §4); GIN runs WITHOUT it.  Trained node "
           "embeddings can be indexed by MonaVec post-hoc (examples/).  "
           "Sampled minibatch mode uses depth=len(fanout)=2 aggregation "
           "blocks per the assigned fanout 15-10."),
))
