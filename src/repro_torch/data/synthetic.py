"""Deterministic synthetic data (copy of ``repro/data/synthetic.py``):
MonaVec's embedding corpora and queries, and the model zoo's token streams,
graphs, fanout samples and recsys batches.

Every array is a pure function of its seed (and step): counter-based Philox
streams, so both packages draw the same bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rng(seed: int, step: int, stream: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=[step, stream, 0, 0]))


# -- token streams (LM) ------------------------------------------------------

def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int):
    """Zipfian token stream with per-sequence drift (non-degenerate loss)."""
    g = _rng(seed, step, 1)
    z = g.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    return {"tokens": (z % vocab).astype(np.int32)}


# -- embedding corpora (MonaVec) ---------------------------------------------

def embedding_corpus(seed: int, n: int, dim: int, *, n_clusters: int = 64,
                     noise: float = 0.25) -> np.ndarray:
    """Clustered vectors with semantic-embedding-like geometry (the AG News
    surrogate: clusters are topics).  Per-document noise scales are drawn from
    U(0.3, 1.5)x, so within-cluster similarities are graded."""
    g = _rng(seed, 0, 2)
    centers = g.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = g.integers(0, n_clusters, size=n)
    scale = (noise * (0.3 + 1.2 * g.random(n))).astype(np.float32)
    x = centers[assign] + scale[:, None] * g.standard_normal((n, dim)).astype(np.float32)
    return x.astype(np.float32)


def pixel_corpus(seed: int, n: int, dim: int) -> np.ndarray:
    """Raw-magnitude, non-Gaussian data (the fashion-mnist surrogate): sparse
    positive "pixels" with block structure, the setting where fit() matters."""
    g = _rng(seed, 0, 3)
    base = g.random((n, dim)).astype(np.float32) * 255.0
    mask = g.random((n, dim)) < 0.55                  # many near-zero pixels
    out = np.where(mask, 0.0, base)
    prototypes = g.random((10, dim)).astype(np.float32) * 128.0
    out += prototypes[g.integers(0, 10, size=n)]
    return out.astype(np.float32)


def queries_from_corpus(corpus: np.ndarray, seed: int, n_q: int,
                        noise: float = 0.15) -> np.ndarray:
    """Noisy copies of seeded corpus rows."""
    g = _rng(seed, 1, 4)
    idx = g.integers(0, len(corpus), size=n_q)
    q = corpus[idx] + noise * g.standard_normal((n_q, corpus.shape[1])).astype(np.float32)
    return q.astype(np.float32)


# -- graphs -------------------------------------------------------------------

def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int):
    """Degree-skewed random graph with community-correlated features/labels."""
    g = _rng(seed, 0, 5)
    n_comm = max(2, n_classes)
    comm = g.integers(0, n_comm, size=n_nodes)
    src = g.integers(0, n_nodes, size=n_edges)
    # 70% of edges stay within the community (homophily).
    intra = g.random(n_edges) < 0.7
    dst_any = g.integers(0, n_nodes, size=n_edges)
    perm = g.permutation(n_nodes)
    comm_members: dict = {}
    for node in range(n_nodes):
        comm_members.setdefault(comm[node], []).append(node)
    dst_intra = np.array(
        [comm_members[comm[s]][g.integers(0, len(comm_members[comm[s]]))]
         for s in src], dtype=np.int64)
    dst = np.where(intra, dst_intra, dst_any)
    feat_centers = g.standard_normal((n_comm, d_feat)).astype(np.float32)
    x = feat_centers[comm] + 0.5 * g.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = comm % n_classes
    return {"x": x.astype(np.float32), "src": src.astype(np.int32),
            "dst": dst.astype(np.int32), "labels": labels.astype(np.int32)}


def neighbor_sample(seed: int, step: int, csr_indptr: np.ndarray,
                    csr_indices: np.ndarray, seeds: np.ndarray,
                    fanouts: Tuple[int, ...]):
    """GraphSAGE-style fanout sampler -> nested-frontier blocks (gnn.forward_sampled).

    Frontiers nest: the first len(parent) rows of each frontier ARE the child
    frontier.  Returns (node_ids of outermost frontier, blocks) where
    blocks[l] = (src_idx, dst_idx, n_dst) index into the running frontier.
    """
    g = _rng(seed, step, 6)
    frontier = np.asarray(seeds, dtype=np.int64)
    blocks = []
    for fanout in fanouts:
        pos = {int(n): i for i, n in enumerate(frontier)}
        src_idx, dst_idx, new_nodes = [], [], []
        for di, node in enumerate(frontier):
            lo, hi = csr_indptr[node], csr_indptr[node + 1]
            if hi > lo:
                picks = csr_indices[lo + g.integers(0, hi - lo, size=fanout)]
                for nb in picks:
                    nb = int(nb)
                    if nb not in pos:
                        pos[nb] = len(frontier) + len(new_nodes)
                        new_nodes.append(nb)
                    src_idx.append(pos[nb])
                    dst_idx.append(di)
        blocks.append((np.asarray(src_idx, np.int32), np.asarray(dst_idx, np.int32),
                       len(frontier)))
        frontier = np.concatenate([frontier, np.asarray(new_nodes, np.int64)])
    # Invert: aggregation runs outermost-first.
    return frontier, blocks[::-1]


# -- recsys -------------------------------------------------------------------

def recsys_batch(seed: int, step: int, arch_id: str, cfg, batch: int):
    """Labels are a deterministic function of the features (learnable signal),
    not coin flips — training tests assert the loss actually decreases."""
    g = _rng(seed, step, 7)
    if arch_id == "dlrm-rm2":
        sparse = g.integers(0, np.asarray(cfg.vocab_sizes),
                            size=(batch, cfg.n_sparse)).astype(np.int32)
        dense = g.standard_normal((batch, cfg.n_dense)).astype(np.float32)
        label = ((sparse[:, 0] + sparse[:, 1]) % 2).astype(np.int32)
        return {"dense": dense, "sparse": sparse, "label": label}
    if arch_id == "dien":
        target_item = g.integers(0, cfg.item_vocab, size=batch).astype(np.int32)
        return {
            "hist_items": g.integers(0, cfg.item_vocab, size=(batch, cfg.seq_len)).astype(np.int32),
            "hist_cats": g.integers(0, cfg.cat_vocab, size=(batch, cfg.seq_len)).astype(np.int32),
            "target_item": target_item,
            "target_cat": g.integers(0, cfg.cat_vocab, size=batch).astype(np.int32),
            "label": (target_item % 2).astype(np.int32),
        }
    if arch_id == "fm":
        sparse = g.integers(0, np.asarray(cfg.vocab_sizes),
                            size=(batch, cfg.n_sparse)).astype(np.int32)
        return {"sparse": sparse,
                "label": ((sparse[:, 0] + sparse[:, 1]) % 2).astype(np.int32)}
    if arch_id == "two-tower-retrieval":
        return {
            "user_hist": g.integers(0, cfg.user_vocab,
                                    size=(batch, cfg.n_user_feats)).astype(np.int32),
            "item_id": g.integers(0, cfg.item_vocab, size=batch).astype(np.int32),
            "item_freq": (g.random(batch).astype(np.float32) * 0.01 + 1e-4),
        }
    raise ValueError(arch_id)
