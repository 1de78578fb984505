"""Decides ``correct``: the program's outputs against the plain reference
(``portbench/reference``), as numbers each held to the cell's limit.  The
traffic kinds' ``outputs`` and ``compare`` hooks call these by what the
window produced: search answers or builds.

Search answers are compared, on a sample of the window's requests drawn
from the seed, each request's own rows (so the batcher's scatter is covered):

* ``code_mismatch``: share of the index's code bytes (and sign-code bytes in
  the cascade) that differ from the reference's encode of the same corpus,
  a code one level off within ``reference.encode.TOL`` of its boundary
  accepted (``reference.encode.judge``);
* ``bad_ids``: returned ids outside the corpus or repeated within a row;
* ``score_err``: the widest gap between a returned score and the reference's
  f64 score of that id, over the rotated query's norm;
* ``rank_gap``: the widest gap by which the reference's score of the id in
  slot j lies below the reference's j-th best (over the same norm); in the
  cascade the best among the reference's survivors;
* ``survivor_miss`` (cascade): returned ids that are not among the
  reference's survivors;
* ``repeat_mismatch``: window requests of a pool row whose scores or ids
  differ in any byte from that row's first answer (every request).

In the cascade a query with a rotated value within TOL of 0 (about one in
eighty) has a sign bit that f32 arithmetic does not fix, and with it its
survivors: such a query is held to the survivors of whichever choice of
those bits (at most four) best fits its returned rows.

Builds compare the first and the last build of the window with the
reference: ``code_mismatch``, ``qnorm_err`` (the widest relative gap of a
row's norm); and ``rebuild_differs``: the window's builds whose codes or
norms differ in any byte from the first's (every build).

``control=True`` puts the reference in the program's place at TF32 (the
precision below the configuration's f32) and judges that instead.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import encode as ref_enc
from portbench.reference import search as ref_search

from . import data
from .context import Context

QUERY_CHUNK = 512


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum().item())


def _repeats(ctx: Context) -> int:
    """Rows of the window whose answer differs from their pool row's first."""
    w = ctx.win
    ok = w["ok"]
    if not ok.any():
        return 0
    k = w["scores"].shape[-1]
    picks = w["picks"][ok].reshape(-1)
    scores = np.ascontiguousarray(w["scores"][ok].reshape(-1, k)).view(np.uint32)
    ids = w["ids"][ok].reshape(-1, k)
    _, first, inverse = np.unique(picks, return_index=True, return_inverse=True)
    base = first[inverse.reshape(-1)]
    differ = (scores != scores[base]).any(axis=1) | (ids != ids[base]).any(axis=1)
    return int(differ.sum())


def sample_requests(ctx: Context):
    """(query rows [S, d], scores [S, k], ids [S, k]) of requests drawn from
    the seed among the window's answered requests."""
    w = ctx.win
    done = np.flatnonzero(w["ok"])
    rng = np.random.default_rng([ctx.seed % (1 << 63), 11])
    take = min(done.shape[0], ctx.cell.traffic["check_requests"])
    chosen = np.sort(done[rng.choice(done.shape[0], size=take, replace=False)])
    k = w["scores"].shape[-1]
    q = ctx.state["pool"][w["picks"][chosen].reshape(-1)]
    return q, w["scores"][chosen].reshape(-1, k), w["ids"][chosen].reshape(-1, k)


def search_outputs(ctx: Context) -> dict:
    """Copy what is judged out of the program's state, free the state, and
    make the corpus again from the seed (checked against the set-up's)."""
    enc = ctx.state["index"].backend.enc
    q, s, i = sample_requests(ctx)
    out = {"packed": enc.packed.clone(), "q": q, "scores": s, "ids": i,
           "ccodes": None if enc.ccodes is None else enc.ccodes.clone(),
           "repeat_mismatch": _repeats(ctx)}
    printed = ctx.state["corpus_print"]
    ctx.state.clear()
    out["corpus"] = data.corpus(ctx.cell.config, ctx.seed, ctx.device)
    if data.fingerprint(out["corpus"]) != printed:
        raise RuntimeError("the corpus made again from the seed is not the set-up's")
    return out


def search_numbers(ctx: Context, out: dict, control: bool = False) -> dict:
    cfg, t = ctx.cell.config, ctx.cell.traffic
    seed, k = cfg["rotation_seed"], t["k"]
    x = out["corpus"]
    dev, n = x.device, x.shape[0]
    m = (t.get("knobs") or {}).get("rescore_mult")
    cascade = m is not None
    q = torch.from_numpy(out["q"]).to(dev)
    if control:      # the reference at TF32 in the program's place
        packed = ref_enc.encode(x, seed, precision="tf32")
        ccodes = ref_enc.sign_codes(packed) if cascade else None
        q_c = ref_enc.encode_queries(q, seed, precision="tf32")
        if cascade:
            planes = ref_search.sign_planes(packed)
            cand = ref_search.survivors(q_c, planes, m * k)
            del planes
            v, r = ref_search.topk_among(q_c, packed, cand, k, precision="tf32")
        else:
            parts = [ref_search.topk_full(q_c[j:j + QUERY_CHUNK], packed, k, precision="tf32")
                     for j in range(0, q_c.shape[0], QUERY_CHUNK)]
            v, r = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        scores = v.float().cpu().numpy()
        ids = r.cpu().numpy().astype(np.uint64)
        repeat = 0
    else:
        packed, ccodes = out["packed"], out["ccodes"]
        scores, ids, repeat = out["scores"], out["ids"], out["repeat_mismatch"]
    differ, ref_packed = ref_enc.judge(x, seed, packed)
    total = ref_packed.numel()
    if cascade:
        ref_cc = ref_enc.sign_codes(ref_packed)
        differ += _mismatch(ccodes, ref_cc)
        total += ref_cc.numel()
        del ref_cc
    nums = {"code_mismatch": differ / total}
    del packed
    ids = ids.astype(np.uint64)
    valid = ids < np.uint64(n)
    srt = np.sort(np.where(valid, ids, np.uint64(n) + np.arange(k, dtype=np.uint64)), axis=1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    nums["bad_ids"] = int((~valid).sum() + dup.sum())
    rows = torch.from_numpy(np.where(valid, ids, 0).astype(np.int64)).to(dev)
    vmask = torch.from_numpy(valid).to(dev)
    q_rot = ref_enc.encode_queries(q, seed)
    qscale = torch.linalg.vector_norm(q_rot, dim=1, keepdim=True)
    s_at = ref_search.scores_at(q_rot, ref_packed, rows)
    got = torch.from_numpy(np.asarray(scores, dtype=np.float32)).to(dev).double()
    err = torch.where(vmask, (got - s_at).abs() / qscale, 0.0)
    nums["score_err"] = float(err.max().item())
    if cascade:
        planes = ref_search.sign_planes(ref_packed)
        cand = ref_search.survivors(q_rot, planes, m * k)
        open_rows = (q_rot.abs() < ref_enc.TOL).any(dim=1)
        for i in torch.nonzero(open_rows).flatten().tolist():
            cand[i] = _closest_survivors(q_rot[i], planes, ref_packed, m * k,
                                         rows[i][vmask[i]], s_at[i][vmask[i]])
        del planes
        inside = (rows[:, :, None] == cand[:, None, :]).any(dim=2)
        nums["survivor_miss"] = int((vmask & ~inside).sum().item())
        best, _ = ref_search.topk_among(q_rot, ref_packed, cand, k)
    else:
        best = torch.cat([ref_search.topk_full(q_rot[j:j + QUERY_CHUNK], ref_packed, k)[0]
                          for j in range(0, q_rot.shape[0], QUERY_CHUNK)])
    gap = torch.where(vmask, (best - s_at) / qscale, 0.0)
    nums["rank_gap"] = float(gap.max().item())
    nums["repeat_mismatch"] = int(repeat)
    return nums


def _closest_survivors(q: torch.Tensor, planes: list, packed: torch.Tensor, m: int,
                       returned: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """[m] the survivors of the rotated query ``q`` under the choice of sign
    bits, among those its values within TOL of 0 leave open (the first four),
    that holds most of the ``returned`` rows and, of those, whose best rows
    lie least above the returned rows' reference ``scores``: each choice is
    an answer the configuration allows."""
    open_at = torch.nonzero(q.abs() < ref_enc.TOL).flatten()[:4].tolist()
    best_key, best = None, None
    for choice in range(1 << len(open_at)):
        qv = q.clone()
        for j, c in enumerate(open_at):
            qv[c] = ref_enc.TOL if choice >> j & 1 else -ref_enc.TOL
        cand = ref_search.survivors(qv[None], planes, m)[0]
        held = int(torch.isin(returned, cand).sum().item())
        top, _ = ref_search.topk_among(q[None], packed, cand[None], returned.numel())
        gap = float((top[0] - scores).max().item()) if returned.numel() else 0.0
        if best_key is None or (held, -gap) > best_key:
            best_key, best = (held, -gap), cand
    return best


def build_outputs(ctx: Context) -> dict:
    first, last = ctx.state["first"], ctx.state["last"]
    out = {"corpus": ctx.state["corpus"], "rebuilds_differ": ctx.win["rebuilds_differ"],
           "builds": [(b.backend.enc.packed, b.backend.enc.qnorms, b.backend.ids)
                      for b in (first, last)]}
    ctx.state.clear()
    return out


def build_numbers(ctx: Context, out: dict, control: bool = False) -> dict:
    seed = ctx.cell.config["rotation_seed"]
    x = out["corpus"]
    ids = np.arange(x.shape[0], dtype=np.uint64)
    if control:
        packed = ref_enc.encode(x, seed, precision="tf32")
        builds = [(packed, ref_enc.norms64(packed).float(), ids)]
    else:
        builds = out["builds"]
    mism, total, qerr = 0, 0, 0.0
    for packed, qn, got_ids in builds:
        differ, ref_packed = ref_enc.judge(x, seed, packed)
        mism += differ
        total += ref_packed.numel()
        ref_qn = ref_enc.norms64(ref_packed)
        rel = (qn.double() - ref_qn).abs() / ref_qn.clamp(min=1e-12)
        qerr = max(qerr, float(rel.max().item()))
        if not np.array_equal(np.asarray(got_ids), ids):
            mism += ref_packed.numel()
        del ref_packed, ref_qn, rel
    return {"code_mismatch": mism / total, "qnorm_err": qerr,
            "rebuild_differs": 0 if control else int(out["rebuilds_differ"])}
