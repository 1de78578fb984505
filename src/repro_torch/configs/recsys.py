"""Assigned RecSys architecture configs."""

from __future__ import annotations

from ..models.recsys import DIENConfig, DLRMConfig, FMConfig, TwoTowerConfig

from .registry import RECSYS_SHAPES, Arch, register


# -- dien [arXiv:1809.03672] -------------------------------------------------

def dien() -> DIENConfig:
    return DIENConfig(name="dien", embed_dim=18, seq_len=100, gru_dim=108,
                      mlp=(200, 80), item_vocab=1 << 20, cat_vocab=1 << 14)


def dien_smoke() -> DIENConfig:
    return DIENConfig(name="dien-smoke", embed_dim=8, seq_len=12, gru_dim=16,
                      mlp=(32, 16), item_vocab=256, cat_vocab=32)


register(Arch(
    arch_id="dien", family="recsys", make_config=dien, make_smoke=dien_smoke,
    shapes=RECSYS_SHAPES,
    notes="retrieval_cand broadcasts one user history against 1M target items "
          "(AUGRU re-evolved per candidate — the DIEN scoring semantics).",
))


# -- dlrm-rm2 [arXiv:1906.00091] ----------------------------------------------

def dlrm() -> DLRMConfig:
    return DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                      vocab_sizes=tuple([1 << 20] * 26),
                      bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


def dlrm_smoke() -> DLRMConfig:
    return DLRMConfig(name="dlrm-smoke", n_dense=13, n_sparse=4, embed_dim=8,
                      vocab_sizes=(64, 64, 64, 64), bot_mlp=(16, 8),
                      top_mlp=(16, 8, 1))


register(Arch(
    arch_id="dlrm-rm2", family="recsys", make_config=dlrm, make_smoke=dlrm_smoke,
    shapes=RECSYS_SHAPES,
))


# -- two-tower-retrieval [RecSys'19 (YouTube)] -------------------------------

def two_tower() -> TwoTowerConfig:
    return TwoTowerConfig(name="two-tower-retrieval", embed_dim=256,
                          tower_mlp=(1024, 512, 256),
                          user_vocab=1 << 21, item_vocab=1 << 21)


def two_tower_smoke() -> TwoTowerConfig:
    return TwoTowerConfig(name="two-tower-smoke", embed_dim=16,
                          tower_mlp=(32, 16), user_vocab=512, item_vocab=512,
                          n_user_feats=4)


register(Arch(
    arch_id="two-tower-retrieval", family="recsys", make_config=two_tower,
    make_smoke=two_tower_smoke, shapes=RECSYS_SHAPES,
    notes="retrieval_cand is the paper's own setting at scale: candidate "
          "scoring dispatches to the MonaVec 4-bit packed scan "
          "(dist.retrieval), with the f32 matmul as the exact baseline.",
))


# -- fm [ICDM'10 (Rendle)] -----------------------------------------------------

def fm() -> FMConfig:
    return FMConfig(name="fm", n_sparse=39, embed_dim=10,
                    vocab_sizes=tuple([1 << 18] * 39))


def fm_smoke() -> FMConfig:
    return FMConfig(name="fm-smoke", n_sparse=6, embed_dim=4,
                    vocab_sizes=tuple([64] * 6))


register(Arch(
    arch_id="fm", family="recsys", make_config=fm, make_smoke=fm_smoke,
    shapes=RECSYS_SHAPES,
))
