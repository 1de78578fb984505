"""Parameter partition rules for the dry-run cells (counterpart of
``repro/dist/sharding.py``).

One rule table per model family, matched against the path string of each
leaf.  Rules name only the TRAILING dims of a leaf: layer-stacked block
params carry an extra leading [L] axis, so specs are right-aligned and
left-padded with None.

A spec is a tuple with one entry a dim: None (replicated), a mesh axis name,
or a tuple of axis names (the dim split over their product); an axis tuple
of one name is that name, and an unmatched leaf's spec is ``()``, fully
replicated, as ``jax.sharding.PartitionSpec`` gives them.  A leaf's path is
the reference's ``jax.tree_util.keystr`` of it in the reference's tree
(``['blocks'][0]['attn']['q']['w']``: dict keys quoted, list indices bare),
the tree ``models.convert.reference_tree`` builds from a module's parameters
with each block's layers stacked to ``[L, ...]``; optimizer moments sit
under ``['m']`` and ``['v']``.  On ``meta`` tensors that tree costs nothing.

LM layout (megatron-style tensor parallelism over the 'model' axis):
  embed [V, D]             V/model   (tied head -> vocab-sharded logits)
  lm_head w [D, V]         V/model
  attn q/k/v w [D, H*dh]   out/model     o w [H*dh, D]  in/model
  mla up-projections       out/model     mla w_o        in/model
  swiglu gate/up [D, F]    F/model       down [F, D]    F/model
  moe w_* [E, D, F]        E/model   (expert parallelism)
  norms / scalars / routers / biases-of-replicated-outs   replicated

RecSys: embedding tables [V, D] are row-sharded (V/model); the MLPs are
replicated.  GNN: everything replicated (the graphs, not the weights, are
what's big; edges shard over 'data').
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Sequence, Tuple, Union

import torch
from torch import nn

from ..launch.mesh import axes_entry
from ..models.convert import reference_tree

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# (path regex, trailing-dims spec): the first match wins.
LM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"\['mtp'\]", ()),                              # MTP head: replicated
    (r"\['embed'\]$", ("model", None)),
    (r"\['lm_head'\]\['w'\]", (None, "model")),
    (r"\['lm_head'\]\['b'\]", ("model",)),
    (r"\['mla'\]\['w_(uq|uk|uv)'\]\['w'\]", (None, "model")),
    (r"\['mla'\]\['w_o'\]\['w'\]", ("model", None)),
    (r"\['attn'\]\['(q|k|v)'\]\['w'\]", (None, "model")),
    (r"\['attn'\]\['(q|k|v)'\]\['b'\]", ("model",)),
    (r"\['attn'\]\['o'\]\['w'\]", ("model", None)),
    (r"\['ffn'\]\['(gate|up)'\]\['w'\]", (None, "model")),
    (r"\['ffn'\]\['down'\]\['w'\]", ("model", None)),
    (r"\['ffn'\]\['w_(gate|up|down)'\]", ("model", None, None)),
    (r"\['ffn'\]\['shared'\]\['(gate|up)'\]\['w'\]", (None, "model")),
    (r"\['ffn'\]\['shared'\]\['down'\]\['w'\]", ("model", None)),
)

RECSYS_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"\['(tables|v|w)'\]\[\d+\]$", ("model", None)),        # DLRM / FM tables
    (r"\['(item_emb|cat_emb|user_emb)'\]$", ("model", None)),  # DIEN / two-tower
)

GNN_RULES: Tuple[Tuple[str, Tuple], ...] = ()


@dataclasses.dataclass(frozen=True)
class ShardedStruct:
    """A leaf's shape and dtype with its spec (the reference's
    ``ShapeDtypeStruct`` with a sharding attached)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec


def spec_for_path(path_str: str, ndim: int, rules: Sequence[Tuple[str, Tuple]]) -> Spec:
    """Match a leaf path against the rule table; right-align the spec."""
    for pat, trailing in rules:
        if re.search(pat, path_str):
            if len(trailing) > ndim:       # e.g. bias of a matched dense
                trailing = trailing[-ndim:] if ndim else ()
            return (None,) * (ndim - len(trailing)) + tuple(trailing)
    return ()


def as_tree(tree):
    """A module as the reference's tree of its parameters; a tree as it is."""
    if isinstance(tree, nn.Module):
        return reference_tree(dict(tree.named_parameters()))
    return tree


def key_paths(tree, prefix: str = "") -> list:
    """``(keystr path, leaf)`` of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in key_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in key_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_shardings(tree, rules: Sequence[Tuple[str, Tuple]]):
    """The spec of every leaf of ``tree`` (a module: its parameters' tree), in
    the tree's structure.  A spec names axes, not sizes, so unlike the
    reference's this takes no mesh."""
    return _map_with_path(lambda path, leaf: spec_for_path(path, len(leaf.shape), rules),
                          as_tree(tree))


def batch_sharding(ndim: int, axes) -> Spec:
    """Shard dim 0 (the batch) over the data axes, rest replicated."""
    return (axes_entry(axes),) + (None,) * (ndim - 1)


def with_shardings(struct_tree, sharding_tree):
    """A tree of ``ShardedStruct``s: each leaf of ``struct_tree`` (a module:
    its parameters' tree) with the spec at its place in ``sharding_tree``
    (one spec for a single tensor)."""
    def zip_(s, sh):
        if isinstance(s, dict):
            return {k: zip_(v, sh[k]) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return [zip_(v, h) for v, h in zip(s, sh)]
        return ShardedStruct(tuple(s.shape), s.dtype, tuple(sh))
    return zip_(as_tree(struct_tree), sharding_tree)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a leaf: each dim over the product of the sizes
    of the axes its spec entry names, rounded up (as XLA pads)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(-(-int(dim) // math.prod(mesh.shape[a] for a in names)))
    return tuple(out)


def bytes_per_device(structs: Any, mesh) -> int:
    """Bytes one device holds of a tree of ``ShardedStruct``s."""
    return sum(math.prod(shard_shape(s.shape, s.spec, mesh)) * s.dtype.itemsize
               for _, s in key_paths(structs) if isinstance(s, ShardedStruct))
