"""Serving steps of the model zoo and the recsys init / loss tables
(counterpart of ``repro/dist/steps.py`` but its dry-run ``Cell``s).

``rs_forward`` is the recsys serving forward of each arch (``_rs_forward``).
``two_tower_retrieve`` is the two-tower ``retrieval_cand`` cell: the user
vector scans a packed 4-bit item corpus, MonaVec's own setting at scale.  It
composes ``user_embedding`` -> ``prepare(u, COSINE)`` -> the quantizer-space
rotation (seed 0x6D6F6E61, unnormalised) -> ``scan_topk_pjit`` (cosine,
k 10); the corpus is ``core.quantize.encode(item_embedding(...))``.  On the
card the rotation is the Hadamard kernel and the scan the 4-bit scan kernel.
``_RS_INIT`` / ``_RS_LOSS`` are the per-arch recsys tables the training
launcher shares (``init(cfg, generator, device)``, ``loss(params, cfg,
batch)``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.rhdh import rhdh_apply
from ..core.standardize import COSINE, prepare
from ..models import recsys as rs
from .retrieval import scan_topk_pjit

# Per-arch recsys init/loss tables (shared with launch.train and chip_smoke).
_RS_INIT = {
    "dlrm-rm2": rs.dlrm_init,
    "dien": rs.dien_init,
    "fm": rs.fm_init,
    "two-tower-retrieval": rs.two_tower_init,
}
_RS_LOSS = {
    "dlrm-rm2": rs.dlrm_loss,
    "dien": rs.dien_loss,
    "fm": rs.fm_loss,
    "two-tower-retrieval": rs.two_tower_loss,
}

#: The item corpus's and the query's rotation seed (``core.quantize.encode``'s default).
RETRIEVAL_SEED = 0x6D6F6E61


def rs_forward(arch_id: str, params, cfg, batch) -> torch.Tensor:
    """The serving forward of a recsys arch over a batch dict of tensors."""
    with torch.no_grad():
        if arch_id == "dlrm-rm2":
            return rs.dlrm_forward(params, cfg, batch["dense"], batch["sparse"])
        if arch_id == "dien":
            return rs.dien_forward(params, cfg, batch)
        if arch_id == "fm":
            return rs.fm_forward(params, cfg, batch["sparse"])
        if arch_id != "two-tower-retrieval":
            raise ValueError(f"unknown recsys arch {arch_id!r}")
        u = rs.user_embedding(params, cfg, batch["user_hist"])
        v = rs.item_embedding(params, cfg, batch["item_id"])
        return torch.sum(u * v, dim=-1)


def two_tower_retrieve(params: rs.TwoTower, cfg: rs.TwoTowerConfig, user_hist: torch.Tensor,
                       packed: torch.Tensor, qnorms: torch.Tensor, *,
                       k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """user_hist [B, n_feats] against a packed 4-bit cosine item corpus
    (``packed`` [n, d'/2] u8, ``qnorms`` [n]) -> (scores [B, k], ids [B, k])."""
    with torch.no_grad():
        u = rs.user_embedding(params, cfg, user_hist)
        q_rot = rhdh_apply(prepare(u, COSINE), RETRIEVAL_SEED, normalized=False)
        return scan_topk_pjit(q_rot, packed, qnorms, metric=COSINE, k=k)
