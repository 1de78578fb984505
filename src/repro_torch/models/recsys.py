"""RecSys architectures: DLRM, DIEN (AUGRU), two-tower retrieval, FM
(counterpart of ``repro/models/recsys.py``).

The embedding lookup is the hot path: ``embedding_bag`` is a row gather and
a segment reduction.  The reduction never adds floats with atomics: rows are
grouped by a stable sort of their bag ids and each bag is summed in lookup
order by ``torch.segment_reduce``, so a bag's bytes are the same every run.

The two-tower model's candidate scoring is either the exact f32 product
(``score_candidates_f32``) or MonaVec's 4-bit packed scan
(``dist.steps.two_tower_retrieve``).  The losses (``bce_loss`` and one a
model) train every table densely, as ``jax.value_and_grad`` does: a row's
gradient is accumulated by ``index_put_``'s sorted (deterministic) form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, dense, mlp, mlp_init, model_device, normal, zeros


# ---------------------------------------------------------------------------
# EmbeddingBag (gather + deterministic segment reduction).
# ---------------------------------------------------------------------------

def embedding_init(vocab: int, dim: int, dtype=torch.float32, device=None,
                   generator=None) -> nn.Parameter:
    return normal((vocab, dim), 1.0 / np.sqrt(dim), dtype, device, generator)


def _segment_lengths(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    bounds = torch.searchsorted(sorted_ids, torch.arange(n + 1, device=sorted_ids.device))
    return bounds[1:] - bounds[:-1]


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                   reduce: str = "sum") -> torch.Tensor:
    """``jax.ops.segment_sum`` / ``segment_max`` over axis 0 with ids in
    [0, num_segments): rows grouped by a stable sort of their ids, each
    segment reduced in row order (empty: 0 for sum, -inf for max)."""
    ids = segment_ids.long()
    sorted_ids, order = torch.sort(ids, stable=True)
    lengths = _segment_lengths(sorted_ids, num_segments)
    return torch.segment_reduce(data[order], reduce, lengths=lengths, axis=0)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, bag_ids: torch.Tensor,
                  n_bags: int, *, combiner: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged multi-hot bag reduce: rows = gather, reduce = segment sum / max."""
    rows = table[indices.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    if combiner == "max":
        return segment_reduce(rows, bag_ids, n_bags, "max")
    out = segment_reduce(rows, bag_ids, n_bags, "sum")
    if combiner == "mean":
        counts = _segment_lengths(torch.sort(bag_ids.long()).values, n_bags).to(torch.float32)
        out = out / torch.clamp(counts, min=1.0)[:, None]
    return out


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, f32.  At a zero logit the
    gradient is the reference's: ``maximum`` splits the tie as
    ``jnp.maximum`` does, and ``|x|``'s slope there is 1, as ``jnp.abs``'s
    (``torch.abs``'s is 0)."""
    lg = logits.to(torch.float32).reshape(-1)
    lb = labels.to(torch.float32).reshape(-1)
    abs_lg = torch.where(lg >= 0, lg, -lg)
    return torch.mean(torch.maximum(lg, torch.zeros_like(lg)) - lg * lb
                      + torch.log1p(torch.exp(-abs_lg)))


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091): bottom MLP + embeddings + dot interaction + top MLP.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_sizes: Tuple[int, ...] = tuple([1 << 20] * 26)   # ~1M rows each
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class DLRM(nn.Module):
    def __init__(self, cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.torch_dtype, device=device, generator=generator)
        n_f = cfg.n_sparse + 1
        d_interact = n_f * (n_f - 1) // 2 + cfg.embed_dim
        self.bot = mlp_init((cfg.n_dense,) + cfg.bot_mlp, **kw)
        self.tables = nn.ParameterList(embedding_init(v, cfg.embed_dim, **kw)
                                       for v in cfg.vocab_sizes)
        self.top = mlp_init((d_interact,) + cfg.top_mlp, **kw)


def dlrm_init(cfg: DLRMConfig, generator: torch.Generator, device="cuda") -> DLRM:
    return DLRM(cfg, generator, device)


def dlrm_forward(params: DLRM, cfg: DLRMConfig, dense_x: torch.Tensor,
                 sparse_ids: torch.Tensor) -> torch.Tensor:
    """dense_x [B, 13]; sparse_ids [B, 26] (single-hot per field) -> logits [B]."""
    z = mlp(params.bot, dense_x, act=F.relu, final_act=F.relu)              # [B, D]
    embs = [t[sparse_ids[:, i].long()] for i, t in enumerate(params.tables)]
    feats = torch.stack([z] + embs, dim=1)                                  # [B, 27, D]
    # Dot interaction: pairwise inner products, strictly-lower triangle.
    f32 = feats.to(torch.float32)
    gram = torch.einsum("bnd,bmd->bnm", f32, f32)
    n_f = cfg.n_sparse + 1
    iu = torch.tril_indices(n_f, n_f, offset=-1, device=feats.device)
    interactions = gram[:, iu[0], iu[1]]                                    # [B, 351]
    top_in = torch.cat([interactions.to(z.dtype), z], dim=-1)
    return mlp(params.top, top_in, act=F.relu)[:, 0]


def dlrm_loss(params: DLRM, cfg: DLRMConfig, batch) -> torch.Tensor:
    return bce_loss(dlrm_forward(params, cfg, batch["dense"], batch["sparse"]), batch["label"])


# ---------------------------------------------------------------------------
# DIEN (arXiv:1809.03672): GRU interest extraction + AUGRU interest evolution.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: Tuple[int, ...] = (200, 80)
    item_vocab: int = 1 << 20
    cat_vocab: int = 1 << 14
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_in(self) -> int:
        return 2 * self.embed_dim       # item ++ category


class GRU(nn.Module):
    """``_gru_init``: ``w`` [d_in, 3 d_h], ``u`` [d_h, 3 d_h], ``b`` [3 d_h]."""

    def __init__(self, d_in: int, d_h: int, *, dtype, device, generator):
        super().__init__()
        self.w = normal((d_in, 3 * d_h), 1.0 / np.sqrt(d_in), dtype, device, generator)
        self.u = normal((d_h, 3 * d_h), 1.0 / np.sqrt(d_h), dtype, device, generator)
        self.b = zeros((3 * d_h,), dtype, device)


def _gru_cell(p: GRU, h, x, *, update_gate_scale=None):
    """Standard GRU cell; AUGRU scales the update gate by the attention weight."""
    gates = x @ p.w + h @ p.u + p.b
    dh = h.shape[-1]
    r = torch.sigmoid(gates[..., :dh])
    z = torch.sigmoid(gates[..., dh:2 * dh])
    if update_gate_scale is not None:
        z = z * update_gate_scale[..., None]             # AUGRU: a_t * z_t
    n = torch.tanh(x @ p.w[:, 2 * dh:] + r * (h @ p.u[:, 2 * dh:]) + p.b[2 * dh:])
    return (1.0 - z) * h + z * n


class DIEN(nn.Module):
    def __init__(self, cfg: DIENConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.torch_dtype, device=device, generator=generator)
        self.item_emb = embedding_init(cfg.item_vocab, cfg.embed_dim, **kw)
        self.cat_emb = embedding_init(cfg.cat_vocab, cfg.embed_dim, **kw)
        self.gru1 = GRU(cfg.d_in, cfg.gru_dim, **kw)
        self.augru = GRU(cfg.gru_dim, cfg.gru_dim, **kw)
        self.att = Dense(cfg.gru_dim + cfg.d_in, 1, bias=True, **kw)
        self.mlp = mlp_init((cfg.gru_dim + 2 * cfg.d_in,) + cfg.mlp + (1,), **kw)


def dien_init(cfg: DIENConfig, generator: torch.Generator, device="cuda") -> DIEN:
    return DIEN(cfg, generator, device)


def dien_forward(params: DIEN, cfg: DIENConfig, batch, *, unroll: bool = False) -> torch.Tensor:
    """batch: hist_items / hist_cats [B,S], target_item / target_cat [B] -> logits [B].

    ``unroll`` is the reference's dry-run switch between ``lax.scan`` and an
    unrolled loop; here both recurrences are one Python loop either way."""
    hist = torch.cat([params.item_emb[batch["hist_items"].long()],
                      params.cat_emb[batch["hist_cats"].long()]], dim=-1)      # [B, S, 2E]
    target = torch.cat([params.item_emb[batch["target_item"].long()],
                        params.cat_emb[batch["target_cat"].long()]], dim=-1)   # [B, 2E]
    b = hist.shape[0]

    # Interest extraction: GRU over the behaviour sequence.
    h = torch.zeros((b, cfg.gru_dim), dtype=hist.dtype, device=hist.device)
    h0 = h
    acc = []
    for t in range(cfg.seq_len):
        h = _gru_cell(params.gru1, h, hist[:, t])
        acc.append(h)
    interests = torch.stack(acc)                                            # [S, B, H]

    # Attention vs the target ad (concat-MLP scoring), softmax over time.
    tgt = target[None].expand(cfg.seq_len, b, cfg.d_in)
    att_logits = dense(params.att, torch.cat([interests, tgt], dim=-1))[..., 0]
    att = torch.softmax(att_logits.to(torch.float32), dim=0).to(hist.dtype)

    # Interest evolution: AUGRU (attention scales the update gate).
    h_final = h0
    for t in range(cfg.seq_len):
        h_final = _gru_cell(params.augru, h_final, interests[t], update_gate_scale=att[t])

    hist_mean = torch.mean(hist, dim=1)
    feats = torch.cat([h_final, target, hist_mean], dim=-1)
    return mlp(params.mlp, feats, act=torch.sigmoid)[:, 0]


def dien_loss(params: DIEN, cfg: DIENConfig, batch) -> torch.Tensor:
    return bce_loss(dien_forward(params, cfg, batch), batch["label"])


# ---------------------------------------------------------------------------
# Two-tower retrieval (RecSys'19).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 1 << 21
    item_vocab: int = 1 << 21
    n_user_feats: int = 8           # multi-hot history bag size
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class TwoTower(nn.Module):
    def __init__(self, cfg: TwoTowerConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.torch_dtype, device=device, generator=generator)
        self.user_emb = embedding_init(cfg.user_vocab, cfg.embed_dim, **kw)
        self.item_emb = embedding_init(cfg.item_vocab, cfg.embed_dim, **kw)
        self.user_tower = mlp_init((cfg.embed_dim,) + cfg.tower_mlp, **kw)
        self.item_tower = mlp_init((cfg.embed_dim,) + cfg.tower_mlp, **kw)


def two_tower_init(cfg: TwoTowerConfig, generator: torch.Generator, device="cuda") -> TwoTower:
    return TwoTower(cfg, generator, device)


def user_embedding(params: TwoTower, cfg: TwoTowerConfig,
                   user_hist: torch.Tensor) -> torch.Tensor:
    """user_hist [B, n_feats] item-id bags -> L2-normalised user vectors [B, D]."""
    b, n = user_hist.shape
    bag_ids = torch.arange(b, device=user_hist.device).repeat_interleave(n)
    bag = embedding_bag(params.user_emb, user_hist.reshape(-1), bag_ids, b, combiner="mean")
    return _l2_normalize(mlp(params.user_tower, bag, act=F.relu))


def item_embedding(params: TwoTower, cfg: TwoTowerConfig,
                   item_ids: torch.Tensor) -> torch.Tensor:
    rows = params.item_emb[item_ids.long()]
    return _l2_normalize(mlp(params.item_tower, rows, act=F.relu))


def two_tower_loss(params: TwoTower, cfg: TwoTowerConfig, batch,
                   temperature: float = 0.05) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (Yi et al., RecSys'19).
    The [B, B] logits are scaled and corrected in place (the bytes of the
    reference's ``(u @ v.T) / t - logq``, one [B, B] buffer fewer)."""
    u = user_embedding(params, cfg, batch["user_hist"])      # [B, D]
    v = item_embedding(params, cfg, batch["item_id"])        # [B, D]
    logits = torch.matmul(u, v.T).div_(temperature)          # [B, B]
    logq = torch.log(torch.clamp(batch["item_freq"], min=1e-9))   # sampling correction
    logits = logits.sub_(logq[None, :])
    labels = torch.arange(u.shape[0], device=u.device)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels[:, None], dim=-1))


def score_candidates_f32(user_vec: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """Exact retrieval scoring: [B, D] x [N, D] -> [B, N] (baseline path)."""
    return torch.matmul(user_vec.to(torch.float32), cand_vecs.to(torch.float32).T)


# ---------------------------------------------------------------------------
# FM (Rendle, ICDM'10): O(nk) sum-square pairwise interactions.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_sizes: Tuple[int, ...] = tuple([1 << 18] * 39)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class FM(nn.Module):
    def __init__(self, cfg: FMConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.torch_dtype, device=device, generator=generator)
        self.v = nn.ParameterList(embedding_init(s, cfg.embed_dim, **kw)
                                  for s in cfg.vocab_sizes)
        self.w = nn.ParameterList(embedding_init(s, 1, **kw) for s in cfg.vocab_sizes)
        self.b = zeros((), cfg.torch_dtype, device)


def fm_init(cfg: FMConfig, generator: torch.Generator, device="cuda") -> FM:
    return FM(cfg, generator, device)


def fm_forward(params: FM, cfg: FMConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids [B, F] -> logits [B].  Pairwise term by the sum-square
    trick: sum_{i<j} <v_i, v_j> = 1/2 [ (sum v_i)^2 - sum v_i^2 ]."""
    ids = sparse_ids.long()
    vs = torch.stack([t[ids[:, i]] for i, t in enumerate(params.v)], dim=1)   # [B, F, K]
    lin = sum(t[ids[:, i]][:, 0] for i, t in enumerate(params.w))             # [B]
    s = torch.sum(vs, dim=1)                                                   # [B, K]
    pair = 0.5 * torch.sum(s * s - torch.sum(vs * vs, dim=1), dim=-1)
    return params.b + lin + pair


def fm_loss(params: FM, cfg: FMConfig, batch) -> torch.Tensor:
    return bce_loss(fm_forward(params, cfg, batch["sparse"]), batch["label"])
