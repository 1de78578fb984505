"""Dry-run cells and the model zoo's serving steps (counterpart of
``repro/dist/steps.py``).

A ``Cell`` bundles one production step of an (arch x shape x variant) on a
production mesh (``launch.mesh.make_production_mesh``) without allocating
anything: the step ``fn``, its arguments on ``torch.device("meta")`` (the
port's modules, optimizer state, batches and caches; Python ints for
scalars such as decode's ``cur_len``), each argument's leaves with their
specs (``dist.sharding``: ``ShardedStruct`` trees), and the reference's
analytic ``model_flops``.  ``fn`` is the port's own step:
``train.optimizer.make_train_step`` over ``lm_loss`` / ``nll_loss`` /
``_RS_LOSS``, ``prefill`` / ``decode_step``, ``rs_forward``,
``two_tower_retrieve`` or the sharded scan; ``launch.dryrun`` counts its
FLOPs on the meta tensors and the bytes a device holds.  ``build_cell``
only builds: it runs nothing.

Variants (LM family): ``baseline`` and ``scan`` run at full depth (the
reference's unrolled and ``lax.scan`` forms, one Python loop here), and
``probeN`` at depth N.  The reference's ``out_shardings``, ``donate`` and
scan-form memory twin (``fn_mem``, ``args_mem``, ...) exist for XLA's
compiler and have no counterpart in eager PyTorch.

``rs_forward`` is the recsys serving forward of each arch (``_rs_forward``).
``two_tower_retrieve`` is the two-tower ``retrieval_cand`` cell: the user
vector scans a packed 4-bit item corpus, MonaVec's own setting at scale.  It
composes ``user_embedding`` -> ``prepare(u, COSINE)`` -> the quantizer-space
rotation (seed 0x6D6F6E61, unnormalised) -> ``scan_topk_pjit`` (cosine,
k 10); the corpus is ``core.quantize.encode(item_embedding(...))``.  On the
card the rotation is the Hadamard kernel and the scan the 4-bit scan kernel;
on ``meta`` their plain versions give the shapes.  ``_RS_INIT`` /
``_RS_LOSS`` are the per-arch recsys tables the training launcher shares
(``init(cfg, generator, device)``, ``loss(params, cfg, batch)``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Tuple

import torch

from ..core.rhdh import next_pow2, rhdh_apply
from ..core.standardize import COSINE, prepare
from ..launch.mesh import Mesh, axes_entry, data_axes
from ..models import gnn as gnn_m
from ..models import recsys as rs
from ..models import transformer as tf
from ..models.convert import reference_tree
from ..train.optimizer import AdamWConfig, init_opt_state, make_train_step
from . import sharding as shd
from .partition import corpus_sharding, data_axis_size, shard_sizes
from .retrieval import make_scan_topk_shardmap, scan_topk_pjit

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


# ---------------------------------------------------------------------------
# Dry-run cells.
# ---------------------------------------------------------------------------

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    """One dry-run step (see ``launch.dryrun``): ``fn(*args)`` on meta
    tensors, ``structs[i]`` the ``ShardedStruct`` tree of ``args[i]`` (None
    for a Python scalar) and ``roles[i]`` what it is: ``params``, ``opt``,
    ``batch``, ``cache`` or ``scalar``.  ``plain_kernels`` names the kernels
    whose plain versions stand in on meta (their FLOPs are what a count of
    ``fn`` sees)."""
    step_name: str
    model_flops: float
    fn: Callable
    args: Tuple[Any, ...]
    structs: Tuple[Any, ...]
    roles: Tuple[str, ...]
    plain_kernels: Tuple[str, ...] = ()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _batch_arg(t: torch.Tensor, spec) -> shd.ShardedStruct:
    return shd.ShardedStruct(tuple(t.shape), t.dtype, tuple(spec))


def _maybe_batch(mesh, axes, ndim: int, dim0: int):
    """Batch spec over the data axes iff dim0 divides evenly, else replicated."""
    n = data_axis_size(mesh)
    if n > 1 and dim0 % n == 0:
        return shd.batch_sharding(ndim, axes)
    return ()


def _count_params(tree, exclude: str = "") -> int:
    """Total leaf elements of a module's (or a tree's) leaves, minus paths
    matching ``exclude`` (regex on the reference's keystr)."""
    total = 0
    for path, leaf in shd.key_paths(shd.as_tree(tree)):
        if exclude and re.search(exclude, path):
            continue
        total += leaf.numel()
    return total


def _opt_tree(state: dict) -> dict:
    """The port's optimizer state as the reference's tree (``['m']``, ``['v']``
    over the parameters' tree, ``['step']``)."""
    tree = {k: reference_tree(state[k]) for k in ("m", "v")}
    tree["step"] = state["step"]
    return tree


def _train_cell(step_name, loss_fn, model, param_structs, batch, batch_structs, flops, *,
                rules, moment_dtype="float32") -> Cell:
    """A train-step Cell: fn(params, opt, *batch) is one ``make_train_step``
    step (gradients and the AdamW update)."""
    ocfg = AdamWConfig(moment_dtype=moment_dtype)
    state = init_opt_state(model, ocfg)
    opt_tree = _opt_tree(state)
    # The rule regexes are sub-path matches, so they apply unchanged under
    # the opt state's ['m'] / ['v'] prefixes.
    opt_structs = shd.with_shardings(opt_tree, shd.tree_shardings(opt_tree, rules))
    step = make_train_step(loss_fn, ocfg)

    def fn(params, opt, *b):
        return step(params, opt, b)

    return Cell(step_name=step_name, model_flops=flops, fn=fn,
                args=(model, state) + tuple(batch),
                structs=(param_structs, opt_structs) + tuple(batch_structs),
                roles=("params", "opt") + ("batch",) * len(batch))


# ---------------------------------------------------------------------------
# LM cells.
# ---------------------------------------------------------------------------

def _parse_variant(variant: str, n_layers: int) -> Tuple[bool, int]:
    """variant -> (unroll, depth)."""
    if variant == "scan":
        return False, n_layers
    m = re.fullmatch(r"probe(\d+)", variant)
    if m:
        return True, int(m.group(1))
    if variant != "baseline":      # a typo'd variant must not silently run
        raise ValueError(f"unknown LM variant {variant!r} "
                         "(expected baseline | scan | probeN)")
    return True, n_layers


def _lm_cfg(arch, mesh, *, unroll: bool, depth: int, kind: str):
    cfg = arch.make_config()
    axes = data_axes(mesh)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, dp_axes=axes, ep_axis="model",
            first_dense_layers=min(moe.first_dense_layers, max(depth - 1, 0)))
    return dataclasses.replace(
        cfg, n_layers=depth, unroll=unroll, moe=moe,
        dp_axes=axes, vocab_shard="model",
        loss_chunk=2048 if kind == "train" else 0,
    )


def _lm_flops(cfg, batch: int, seq: int, *, mode: str) -> float:
    """Analytic global-batch FLOPs: 2*active_params*tokens matmul term plus
    the attention score/value term (window-aware), x3 for backward."""
    n_act = cfg.active_param_count()
    d_attn = cfg.n_heads * cfg.head_dim
    if mode == "decode":
        matmul = 2.0 * n_act * batch
        attn = sum(4.0 * batch * min(seq, w if w > 0 else seq) * d_attn
                   for w in cfg.layer_windows())
        return matmul + attn
    matmul = 2.0 * n_act * batch * seq
    attn = sum(4.0 * batch * seq * min(seq, w if w > 0 else seq) * d_attn
               for w in cfg.layer_windows())
    fwd = matmul + attn
    return 3.0 * fwd if mode == "train" else fwd


def _decode_cache_structs(cfg, mesh, axes, batch: int, max_len: int):
    """(the decode cache on meta, its ShardedStruct tree, whether the batch
    is split): caches split by batch or, when it does not divide (long
    context), by sequence, with KV heads over ``model``."""
    cache = tf.init_decode_cache(cfg, batch, max_len, device=META)
    n_data = data_axis_size(mesh)
    shard_batch = batch % n_data == 0 and n_data > 1
    entry = axes_entry(axes)

    def sh(leaf):
        # [L, B, S, KV, dh] (GQA) or [L, B, S, C] (MLA latent).
        spec = [None] * leaf.dim()
        if shard_batch:
            spec[1] = entry
        else:
            spec[2] = entry            # long-context: sequence-sharded cache
        if leaf.dim() == 5 and leaf.shape[3] % mesh.shape["model"] == 0:
            spec[3] = "model"          # KV heads over the model axis
        return tuple(spec)

    specs = [{k: sh(t) for k, t in block.items()} for block in cache]
    return cache, shd.with_shardings(cache, specs), shard_batch


def _build_lm(arch, shape, mesh, variant: str) -> Cell:
    axes = data_axes(mesh)
    kind = shape.kind
    dims = shape.dims
    seq, batch = dims["seq_len"], dims["global_batch"]
    unroll, depth = _parse_variant(variant, arch.make_config().n_layers)
    cfg = _lm_cfg(arch, mesh, unroll=unroll, depth=depth, kind=kind)
    model = tf.Transformer(cfg, device=META)
    p_structs = shd.with_shardings(model, shd.tree_shardings(model, shd.LM_RULES))
    flops = _lm_flops(cfg, batch, seq,
                      mode="train" if kind == "train" else
                      ("decode" if kind == "decode" else "prefill"))

    if kind == "train":
        tok = _meta((batch, seq), torch.int32)
        tok_s = _batch_arg(tok, _maybe_batch(mesh, axes, 2, batch))
        return _train_cell(
            f"lm_train[{variant}]", lambda p, b: tf.lm_loss(p, cfg, b[0]), model, p_structs,
            (tok,), (tok_s,), flops, rules=shd.LM_RULES,
            moment_dtype="bfloat16" if cfg.moe else "float32")

    if kind == "prefill":
        tok = _meta((batch, seq), torch.int32)

        def fn(params, tokens):
            return tf.prefill(params, cfg, tokens, last_only=True)

        return Cell(step_name=f"lm_prefill[{variant}]", model_flops=flops, fn=fn,
                    args=(model, tok),
                    structs=(p_structs, _batch_arg(tok, _maybe_batch(mesh, axes, 2, batch))),
                    roles=("params", "batch"))

    # decode: one token against a [*, batch, seq] cache, at its last position.
    cache, cache_structs, shard_batch = _decode_cache_structs(cfg, mesh, axes, batch, seq)
    if not shard_batch:
        # Sequence-sharded cache (gemma2 long_500k), as the reference's
        # config says it; on one device these fields change nothing.
        cfg = dataclasses.replace(cfg, attn_seq_shard=axes[-1], attn_seq_axis="kv",
                                  dp_axes=None)
    tok = _meta((batch, 1), torch.int32)

    def fn(params, cache_, tokens, cur_len):
        return tf.decode_step(params, cfg, cache_, tokens, cur_len)

    return Cell(step_name=f"lm_decode[{variant}]", model_flops=flops, fn=fn,
                args=(model, cache, tok, seq - 1),
                structs=(p_structs, cache_structs,
                         _batch_arg(tok, _maybe_batch(mesh, axes, 2, batch)), None),
                roles=("params", "cache", "batch", "scalar"))


# ---------------------------------------------------------------------------
# GNN cells.
# ---------------------------------------------------------------------------

def _gnn_flops(cfg, n_nodes: int, n_edges: int, train: bool) -> float:
    per_node = 0.0
    for i in range(cfg.n_layers):
        d_in = cfg.d_feat if i == 0 else cfg.d_hidden
        per_node += 2.0 * (d_in * cfg.d_hidden + cfg.d_hidden * cfg.d_hidden)
    fwd = n_nodes * per_node + 2.0 * n_edges * cfg.d_hidden  # + scatter adds
    return 3.0 * fwd if train else fwd


def _gnn_batch(mesh, axes, parts):
    """(meta tensors, their ShardedStructs) of ``(shape, dtype, sharded)``
    parts: a sharded part splits dim 0 over the data axes where it divides."""
    ts = [_meta(shape, dt) for shape, dt, _ in parts]
    return ts, [_batch_arg(t, _maybe_batch(mesh, axes, t.dim(), t.shape[0]) if sharded else ())
                for t, (_, _, sharded) in zip(ts, parts)]


def _build_gnn(arch, shape, mesh, variant: str) -> Cell:
    axes = data_axes(mesh)
    dims = shape.dims
    base = arch.make_config()
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "minibatch":
        cfg = dataclasses.replace(base, d_feat=dims["d_feat"], n_classes=dims["n_classes"],
                                  n_layers=2)   # depth = len(fanout)
        b = dims["batch_nodes"]
        f0, f1 = dims["fanout0"], dims["fanout1"]
        # Worst-case nested frontiers (the sampler guarantees <= these).
        n1 = b + b * f0
        e_outer, e_inner = n1 * f1, b * f0
        n2 = n1 + e_outer
        model = gnn_m.GIN(cfg, device=META)

        def loss_fn(p, batch):
            feats, sa, da, sb, db, labels = batch
            logits = gnn_m.forward_sampled(p, cfg, feats, [(sa, da, n1), (sb, db, b)])
            return gnn_m.nll_loss(logits, labels)

        batch, structs = _gnn_batch(mesh, axes, [
            ((n2, cfg.d_feat), f32, False),
            ((e_outer,), i32, True), ((e_outer,), i32, True),
            ((e_inner,), i32, True), ((e_inner,), i32, True),
            ((b,), i32, False)])
        flops = _gnn_flops(cfg, n2, e_outer + e_inner, True)
        step = "gnn_minibatch_train"
    elif shape.kind == "graphs":
        cfg = dataclasses.replace(base, d_feat=dims["d_feat"], n_classes=dims["n_classes"],
                                  readout="graph")
        g = dims["batch"]
        n, e = dims["n_nodes"] * g, dims["n_edges"] * g
        model = gnn_m.GIN(cfg, device=META)
        gid = torch.arange(g, device=META)[:, None].expand(g, dims["n_nodes"]).reshape(-1)

        def loss_fn(p, batch):
            x, src, dst, labels = batch
            logits = gnn_m.forward_full(p, cfg, x, src, dst, graph_ids=gid, n_graphs=g)
            return gnn_m.nll_loss(logits, labels)

        batch, structs = _gnn_batch(mesh, axes, [
            ((n, cfg.d_feat), f32, True), ((e,), i32, True), ((e,), i32, True),
            ((g,), i32, False)])
        flops = _gnn_flops(cfg, n, e, True)
        step = "gnn_graphs_train"
    else:   # full_graph (cora-like / ogbn-products-like)
        cfg = dataclasses.replace(base, d_feat=dims["d_feat"], n_classes=dims["n_classes"])
        n, e = dims["n_nodes"], dims["n_edges"]
        model = gnn_m.GIN(cfg, device=META)

        def loss_fn(p, batch):
            x, src, dst, labels = batch
            return gnn_m.nll_loss(gnn_m.forward_full(p, cfg, x, src, dst), labels)

        batch, structs = _gnn_batch(mesh, axes, [
            ((n, cfg.d_feat), f32, True), ((e,), i32, True), ((e,), i32, True),
            ((n,), i32, False)])
        flops = _gnn_flops(cfg, n, e, True)
        step = "gnn_full_graph_train"
    p_structs = shd.with_shardings(model, shd.tree_shardings(model, shd.GNN_RULES))
    return _train_cell(step, loss_fn, model, p_structs, batch, structs, flops,
                       rules=shd.GNN_RULES)


# ---------------------------------------------------------------------------
# RecSys cells.
# ---------------------------------------------------------------------------

# Embedding-table paths = exactly what RECSYS_RULES shards (one source of
# truth); DLRM/FM tables are indexed lists, so a dense layer's terminal
# ['w'] never matches.
_RS_TABLES = "|".join(pat for pat, _ in shd.RECSYS_RULES)

def _rs_batch_structs(arch_id: str, cfg, batch: int, mesh, axes, serve: bool = False):
    """(the batch dict on meta, its ShardedStruct dict)."""
    i32, f32 = torch.int32, torch.float32
    if arch_id == "dlrm-rm2":
        d = {"dense": ((batch, cfg.n_dense), f32), "sparse": ((batch, cfg.n_sparse), i32)}
    elif arch_id == "dien":
        d = {"hist_items": ((batch, cfg.seq_len), i32), "hist_cats": ((batch, cfg.seq_len), i32),
             "target_item": ((batch,), i32), "target_cat": ((batch,), i32)}
    elif arch_id == "fm":
        d = {"sparse": ((batch, cfg.n_sparse), i32)}
    else:  # two-tower-retrieval
        d = {"user_hist": ((batch, cfg.n_user_feats), i32), "item_id": ((batch,), i32),
             "item_freq": ((batch,), f32)}
    if not serve and arch_id != "two-tower-retrieval":
        d["label"] = ((batch,), i32)
    ts = {k: _meta(shape, dt) for k, (shape, dt) in d.items()}
    return ts, {k: _batch_arg(t, _maybe_batch(mesh, axes, t.dim(), batch))
                for k, t in ts.items()}


def _rs_flops(arch_id: str, model, cfg, batch: int, train: bool) -> float:
    dense_params = _count_params(model, exclude=_RS_TABLES)
    fwd = 2.0 * dense_params * batch
    if arch_id == "dien":  # recurrences run seq_len steps over [B, H]
        fwd *= cfg.seq_len / 4.0
    return 3.0 * fwd if train else fwd


def _build_recsys(arch, shape, mesh, variant: str) -> Cell:
    axes = data_axes(mesh)
    arch_id = arch.arch_id
    cfg = arch.make_config()
    loss = _RS_LOSS[arch_id]
    model = _RS_INIT[arch_id](cfg, None, META)      # no generator: meta draws nothing
    p_structs = shd.with_shardings(model, shd.tree_shardings(model, shd.RECSYS_RULES))

    if shape.kind == "recsys_train":
        batch = shape.dims["batch"]
        b, structs = _rs_batch_structs(arch_id, cfg, batch, mesh, axes)

        def loss_fn(p, bb):
            return loss(p, cfg, bb[0])

        return _train_cell(f"{arch_id}_train", loss_fn, model, p_structs, (b,),
                           (structs,), _rs_flops(arch_id, model, cfg, batch, True),
                           rules=shd.RECSYS_RULES)

    if shape.kind == "recsys_serve":
        batch = shape.dims["batch"]
        b, structs = _rs_batch_structs(arch_id, cfg, batch, mesh, axes, serve=True)

        def fn(params, bb):
            return rs_forward(arch_id, params, cfg, bb)

        return Cell(step_name=f"{arch_id}_serve",
                    model_flops=_rs_flops(arch_id, model, cfg, batch, False), fn=fn,
                    args=(model, b), structs=(p_structs, structs), roles=("params", "batch"))

    # retrieval_cand: 1 user vs n_candidates items.
    return _build_rs_retrieval(arch_id, cfg, model, p_structs, mesh, axes,
                               shape.dims["n_candidates"])


def _build_rs_retrieval(arch_id, cfg, model, p_structs, mesh, axes, n_cand: int) -> Cell:
    csh1 = _maybe_batch(mesh, axes, 1, n_cand)
    csh2 = _maybe_batch(mesh, axes, 2, n_cand)
    i32 = torch.int32

    if arch_id == "two-tower-retrieval":
        # The paper's own setting: the user vector scans a PACKED 4-bit item
        # corpus (B2 rotates the query, B1 scans; their plain versions on meta).
        d_pad = next_pow2(cfg.embed_dim)
        args = (model, _meta((1, cfg.n_user_feats), i32),
                _meta((n_cand, d_pad // 2), torch.uint8), _meta((n_cand,), torch.float32))
        structs = (p_structs, _batch_arg(args[1], ()), _batch_arg(args[2], csh2),
                   _batch_arg(args[3], csh1))

        def fn(params, user_hist, packed, qnorms):
            return two_tower_retrieve(params, cfg, user_hist, packed, qnorms, k=10)

        flops = 2.0 * n_cand * d_pad + 2.0 * _count_params(model, exclude=_RS_TABLES)
        return Cell(step_name="two_tower_packed_scan", model_flops=flops, fn=fn, args=args,
                    structs=structs, roles=("params", "batch", "batch", "batch"),
                    plain_kernels=("B2 (Hadamard)", "B1 (4-bit scan)"))

    if arch_id == "dien":
        # One user history broadcast against every candidate (AUGRU
        # re-evolved per candidate: the DIEN scoring semantics).
        args = (model, _meta((1, cfg.seq_len), i32), _meta((1, cfg.seq_len), i32),
                _meta((n_cand,), i32), _meta((n_cand,), i32))
        structs = (p_structs, _batch_arg(args[1], ()), _batch_arg(args[2], ()),
                   _batch_arg(args[3], csh1), _batch_arg(args[4], csh1))

        def fn(params, hist_items, hist_cats, target_item, target_cat):
            batch = {"hist_items": hist_items.expand(n_cand, cfg.seq_len),
                     "hist_cats": hist_cats.expand(n_cand, cfg.seq_len),
                     "target_item": target_item, "target_cat": target_cat}
            return rs_forward("dien", params, cfg, batch)

        return Cell(step_name="dien_candidate_scan",
                    model_flops=_rs_flops("dien", model, cfg, n_cand, False), fn=fn, args=args,
                    structs=structs, roles=("params",) + ("batch",) * 4)

    # dlrm / fm: pointwise scoring of the candidate batch.
    b, structs = _rs_batch_structs(arch_id, cfg, n_cand, mesh, axes, serve=True)

    def fn(params, bb):
        return rs_forward(arch_id, params, cfg, bb)

    return Cell(step_name=f"{arch_id}_candidate_scan",
                model_flops=_rs_flops(arch_id, model, cfg, n_cand, False), fn=fn,
                args=(model, b), structs=(p_structs, structs), roles=("params", "batch"))


# ---------------------------------------------------------------------------
# Retrieval cells (monavec-scan: the paper's workload as an arch).
# ---------------------------------------------------------------------------

def _build_retrieval(arch, shape, mesh, variant: str) -> Cell:
    cfg = arch.make_config()
    n, bq = shape.dims["n_corpus"], shape.dims["batch_q"]
    d_pad = next_pow2(cfg.dim)
    n_shards = data_axis_size(mesh)
    _, n_pad = shard_sizes(n, n_shards)

    # One shard a data-axis index, each on meta (B1's plain version there).
    fn = make_scan_topk_shardmap(Mesh((META,) * n_shards), metric=cfg.metric, k=cfg.k,
                                 bits=cfg.bits, n_valid=n)
    args = (_meta((bq, d_pad), torch.float32), _meta((n_pad, d_pad // 2), torch.uint8),
            _meta((n_pad,), torch.float32))
    structs = (_batch_arg(args[0], ()), _batch_arg(args[1], corpus_sharding(mesh, 2)),
               _batch_arg(args[2], corpus_sharding(mesh, 1)))
    # Same MAC count as the f32 scan (dequantization is elementwise).
    flops = 2.0 * bq * float(n) * d_pad
    return Cell(step_name="monavec_scan_shardmap", model_flops=flops, fn=fn, args=args,
                structs=structs, roles=("batch",) * 3, plain_kernels=("B1 (4-bit scan)",))


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------

def build_cell(arch, shape, mesh, variant: str = "baseline") -> Cell:
    """Construct the dry-run Cell for one (arch, shape) on a mesh (a
    ``launch.mesh.MeshShape``).  Nothing is allocated: parameters, state,
    batches and caches are meta tensors, and nothing runs."""
    if arch.family == "lm":
        return _build_lm(arch, shape, mesh, variant)
    if arch.family == "gnn":
        return _build_gnn(arch, shape, mesh, variant)
    if arch.family == "recsys":
        return _build_recsys(arch, shape, mesh, variant)
    if arch.family == "retrieval":
        return _build_retrieval(arch, shape, mesh, variant)
    raise ValueError(f"unknown family {arch.family!r}")
