"""Carry the reference's parameters across: a tree of numpy arrays in
``repro.models``' layout becomes the port's module.

The tree is what the reference's ``init_params`` / ``*_init`` return, each
leaf passed through ``np.asarray``: nested dicts and lists.  A transformer's
``blocks`` list holds stacked ``[L, ...]`` arrays (the reference scans over
them); here they become layer ``i`` of block ``b`` (``blocks.b.i.<key>``).
Every other dict key and list index is the module path as it stands.  Dtypes
are kept (bf16 arrays, numpy's ``ml_dtypes`` bfloat16, included).  Nothing
here reads a JAX array.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
from torch import nn

from .gnn import GIN, GINConfig
from .layers import model_device
from .recsys import DIEN, DLRM, FM, DIENConfig, DLRMConfig, FMConfig, TwoTower, TwoTowerConfig
from .transformer import Transformer, TransformerConfig

MODEL_OF = {TransformerConfig: Transformer, GINConfig: GIN, DLRMConfig: DLRM,
            DIENConfig: DIEN, TwoTowerConfig: TwoTower, FMConfig: FM}


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch with the dtype kept (bfloat16 through its bits)."""
    a = np.array(a, order="C")            # a C-ordered copy (0-d stays 0-d)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _flatten(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def state_dict_of(tree) -> Dict[str, torch.Tensor]:
    """The reference's tree as the port's state-dict keys and tensors."""
    flat: Dict[str, np.ndarray] = {}
    tree = dict(tree) if isinstance(tree, dict) else tree
    blocks = tree.pop("blocks", None) if isinstance(tree, dict) else None
    _flatten(tree, "", flat)
    for b, block in enumerate(blocks or ()):
        stacked: Dict[str, np.ndarray] = {}
        _flatten(block, "", stacked)
        n = {a.shape[0] for a in stacked.values()}
        if len(n) != 1:
            raise ValueError(f"block {b}: stacked leaves disagree on the layer count {n}")
        for key, a in stacked.items():
            for i in range(a.shape[0]):
                flat[f"blocks.{b}.{i}.{key}"] = a[i]
    return {key: to_tensor(a) for key, a in flat.items()}


def from_reference_params(family_or_arch: Union[str, object], tree, device="cuda") -> nn.Module:
    """The port's module holding the reference parameter ``tree``.

    ``family_or_arch`` is a model config (``TransformerConfig``, ``GINConfig``,
    ``DLRMConfig``, ``DIENConfig``, ``TwoTowerConfig``, ``FMConfig``) or a
    registry arch id (its full config).  Every key must match: a missing or
    extra leaf, or a shape that differs, raises."""
    cfg = family_or_arch
    if isinstance(cfg, str):
        from ..configs import get
        cfg = get(cfg).make_config()
    cls = MODEL_OF.get(type(cfg))
    if cls is None:
        raise TypeError(f"no port module for a {type(cfg).__name__}")
    dev = model_device(device)
    model = cls(cfg, device="meta")
    sd = state_dict_of(tree)
    own = {k: p for k, p in model.state_dict().items()}
    for key, t in sd.items():
        if key in own and tuple(own[key].shape) != tuple(t.shape):
            raise ValueError(f"{key}: the tree has shape {tuple(t.shape)}, the "
                             f"{type(cfg).__name__} wants {tuple(own[key].shape)}")
    model.load_state_dict({k: t.to(dev) for k, t in sd.items()}, strict=True, assign=True)
    return model
