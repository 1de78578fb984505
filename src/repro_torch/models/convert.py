"""Carry the reference's parameters across: a tree of numpy arrays in
``repro.models``' layout becomes the port's module, and back
(``to_reference_params``).

The tree is what the reference's ``init_params`` / ``*_init`` return, each
leaf passed through ``np.asarray``: nested dicts and lists.  A transformer's
``blocks`` list holds stacked ``[L, ...]`` arrays (the reference scans over
them); here they become layer ``i`` of block ``b`` (``blocks.b.i.<key>``).
Every other dict key and list index is the module path as it stands.  Dtypes
are kept (bf16 arrays, numpy's ``ml_dtypes`` bfloat16, included).  Nothing
here reads a JAX array.  The way back stacks block ``b``'s layers into
``blocks[b]``'s ``[L, ...]`` leaves and turns every module path into dict
keys, a numeric part into a list index (``ModuleList`` / ``ParameterList``,
the reference's lists); ``reference_tree`` does it for any flat
``{name: tensor}`` (gradients, optimizer moments).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Union

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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host, the dtype kept: a bfloat16 tensor becomes
    an ``ml_dtypes`` bfloat16 array where ``ml_dtypes`` is installed, else
    its raw 2-byte values (``np.dtype("V2")``, what numpy loads from the
    reference's bfloat16 ``.npy`` files)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return bits.view(np.dtype("V2"))
    return bits.view(ml_dtypes.bfloat16)


def _flatten(tree, prefix: str, out: Dict[str, object]) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _flatten(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)


def state_dict_of(tree) -> Dict[str, torch.Tensor]:
    """The reference's tree (numpy arrays or torch tensors) as the port's
    state-dict keys and tensors."""
    flat: Dict[str, object] = {}
    tree = dict(tree) if isinstance(tree, dict) else tree
    blocks = tree.pop("blocks", None) if isinstance(tree, dict) else None
    _flatten(tree, "", flat)
    for b, block in enumerate(blocks or ()):
        stacked: Dict[str, object] = {}
        _flatten(block, "", stacked)
        n = {a.shape[0] for a in stacked.values()}
        if len(n) != 1:
            raise ValueError(f"block {b}: stacked leaves disagree on the layer count {n}")
        for key, a in stacked.items():
            for i in range(a.shape[0]):
                flat[f"blocks.{b}.{i}.{key}"] = a[i]
    return {key: a if isinstance(a, torch.Tensor) else to_tensor(a) for key, a in flat.items()}


def listify(node):
    """Dicts whose keys are all list indices become lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _insert(root: dict, parts, leaf) -> None:
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def reference_tree(flat: Mapping[str, torch.Tensor],
                   stack: Callable = torch.stack) -> Union[dict, list]:
    """A flat ``{port parameter name: tensor}`` as the reference's tree:
    ``blocks.b.i.<key>`` leaves stacked over ``i`` (by ``stack``) under
    ``blocks[b]``, every other name split into nested dicts and lists."""
    root: dict = {}
    blocks: Dict[int, Dict[str, Dict[int, torch.Tensor]]] = {}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            layers = blocks.setdefault(int(parts[1]), {}).setdefault(".".join(parts[3:]), {})
            layers[int(parts[2])] = t
        else:
            _insert(root, parts, t)
    if blocks:
        root["blocks"] = [{} for _ in range(len(blocks))]
        for b, leaves in blocks.items():
            for key, layers in leaves.items():
                _insert(root["blocks"][b], key.split("."),
                        stack([layers[i] for i in range(len(layers))]))
    return listify(root)


def to_reference_params(model: nn.Module):
    """The inverse of ``from_reference_params``: the reference's numpy tree
    of ``model``'s parameters (blocks stacked to ``[L, ...]``, dtypes kept,
    bfloat16 as ``to_numpy`` gives it)."""
    tree = reference_tree({k: p.detach() for k, p in model.named_parameters()})
    return _map_leaves(tree, to_numpy)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


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
