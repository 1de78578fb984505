"""GIN, the Graph Isomorphism Network (arXiv:1810.00826), over an explicit
edge index (counterpart of ``repro/models/gnn.py``).

Message passing gathers source rows and sums them into destinations with
``recsys.segment_reduce``: a stable sort by destination and a per-segment
sum in edge order, with no float atomics, so a forward's bytes are the same
every run on the card.

Modes: full-graph node classification, sampled minibatches over nested
fanout frontiers (``data.synthetic.neighbor_sample``), and batched small
graphs with a sum readout (``readout="graph"``).  The forwards build an
autograd graph once the parameters ask for gradients (training:
``nll_loss``); they are created without.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import mlp, mlp_init, model_device, zeros
from .recsys import segment_reduce


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    readout: str = "node"          # "node" | "graph"
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, *, dtype, device, generator):
        super().__init__()
        self.mlp = mlp_init((d_in, d_hidden, d_hidden), dtype=dtype, device=device,
                            generator=generator)
        self.eps = zeros((), dtype, device)            # learnable (GIN-eps)


class GIN(nn.Module):
    """The reference's ``init_params``: ``layers`` (an MLP and an eps each) and the
    ``head`` MLP."""

    def __init__(self, cfg: GINConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.torch_dtype, device=device, generator=generator)
        self.layers = nn.ModuleList(
            GINLayer(cfg.d_feat if i == 0 else cfg.d_hidden, cfg.d_hidden, **kw)
            for i in range(cfg.n_layers))
        self.head = mlp_init((cfg.d_hidden, cfg.n_classes), **kw)


def gin_layer(lp: GINLayer, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              n_nodes: int) -> torch.Tensor:
    """h'_i = MLP((1+eps) h_i + sum_{j in N(i)} h_j)."""
    msgs = x[src.long()]                                      # [E, D] gather
    agg = segment_reduce(msgs, dst, n_nodes)
    h = (1.0 + lp.eps) * x + agg
    return mlp(lp.mlp, h, act=F.relu, final_act=F.relu)


def forward_full(params: GIN, cfg: GINConfig, x: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor, graph_ids: Optional[torch.Tensor] = None,
                 n_graphs: int = 1) -> torch.Tensor:
    """Full-graph forward.  x [N, F]; edges as index tensors.  Returns node
    logits [N, C] (readout="node") or graph logits [G, C]."""
    n = x.shape[0]
    for lp in params.layers:
        x = gin_layer(lp, x, edge_src, edge_dst, n)
    if cfg.readout == "graph":
        if graph_ids is None:
            raise ValueError("readout='graph' needs graph_ids")
        return mlp(params.head, segment_reduce(x, graph_ids, n_graphs))
    return mlp(params.head, x)


def forward_sampled(params: GIN, cfg: GINConfig, feats: torch.Tensor,
                    blocks: Tuple[Tuple[torch.Tensor, torch.Tensor, int], ...]) -> torch.Tensor:
    """Minibatch forward over fanout-sampled blocks (nested frontiers, seeds
    first).  ``feats`` are the outermost frontier's features;
    ``blocks[l] = (src, dst, n_dst)`` index the current frontier (src) and
    the next, smaller one (dst).  Aggregation depth = len(blocks)."""
    h = feats
    for layer, (src, dst, n_dst) in zip(params.layers, blocks):
        agg = segment_reduce(h[src.long()], dst, n_dst)
        hh = (1.0 + layer.eps) * h[:n_dst] + agg
        h = mlp(layer.mlp, hh, act=F.relu, final_act=F.relu)
    return mlp(params.head, h)


def nll_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood, f32; over the ``mask``ed nodes when given."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    if mask is not None:
        mask = mask.to(ll.dtype)
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return -torch.mean(ll)
