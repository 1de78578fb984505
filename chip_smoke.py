#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MonaVec on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json report.json] [--parent-csrc DIR]

Phases, in order (any failure exits non-zero and prints no result line):

1. check the card and print its ``nvidia-smi`` name and power limit;
2. build the four CUDA sources (src/repro_torch/csrc/) with nvcc, in parallel;
3. hold each kernel against its plain PyTorch version on the card, from
   numpy-seeded inputs: the Hadamard kernel byte for byte against the
   stage-order butterfly and within tolerance of the Kronecker version at
   every d' = 2^0 .. 2^17 (d ragged and whole, rows at and off 16-byte
   alignment), at d' in {8, 16, 1024, 4096, 32768, 65536, 131072, 2^20,
   2^21} and at the main shape, the 4-bit scan at b in {1, 7, 64} x
   n in {1, 300, n} (d'=1024), at d'=16, and at n=1,000,000; the sign and
   crumb proxies bit for bit at the same b x n grid, at d' in {8, 16, 136,
   4096}, at odd n, at b=65, at n in {127, 129, 255, 257} (row tiles ragged
   on either side) and at n=1,000,000, and each at b = 64 x 65,535 + 1 (two
   launches) byte-equal to its two halves; the 2-bit scan at the same
   b x n grid, at d'=16 and at
   n=1,000,000; the gathered 4-bit and 2-bit rescores at b in {1, 7, 64} x
   m in {1, 33, 80, 320, 1280} (d'=1024) and at d' in {16, 4096}, with
   candidates of -1 and >= n among them, each within tolerance of its plain
   version and byte for byte against the full scan of its width at the same
   (query, row); mixed 4/2-bit full and gathered scans through column views
   of one code tensor (n4 = 512 of d'=1024, and the small splits 4 of 16
   and 36 of 64), and each of the four scan kernels on a view byte-equal to
   its launch on a contiguous copy; each gathered rescore at b=65,536 (two
   launches) byte-equal to its two halves; with ``--parent-csrc``, the
   4-bit and 2-bit full scans, the Hadamard kernel and both proxies byte
   for byte against the parent's kernels at every one of those shapes the
   parent takes;
4. run the main path: ``MonaVec.build`` (cosine, BruteForce, 4-bit) over the
   seeded AG News stand-in, then 10 batches of 64 queries at k=10, reading
   the kernels' launch counters around it; recall@10 against exact f32
   cosine on the card; a repeated search must be byte-identical, and
   save -> load -> search equal; the encode's codes are counted against
   the plain (Kronecker) rotation on the card and a CPU encode;
4b. run the cascade path on the phase-4 index: for ``enable_coarse("sign")``
   and ``("crumb")`` at ``rescore_mult`` 8 and 32, 10 batches of 64 at k=10
   with the launch counters set to 0 before and read after (the proxy and
   gathered kernels must run, the full-scan kernel must not); recall@10
   against exact f32 cosine and the full scan; the port's plain cascade on
   the CPU over the same encoding; every returned score byte-equal to the
   full scan's score of that id; determinism; v10 save -> load -> search;
4c. run 2-bit and mixed precision at the same size: ``build(bits=2)``,
   ``build(avg_bits=3.0)`` (the 4-bit block on the leading dims) and a v7
   index (``encode_mixed`` with the variance permutation of the first 512
   rotated rows), each with the launch counters around 10 batches of 64;
   recall@10 against exact f32 cosine and the port's plain path on the CPU;
   repeat and save -> load -> search byte-identical; code flips of the card
   encode against the CPU encode; then the crumb cascade (2-bit and v7) or
   the sign cascade (mixed) at ``rescore_mult=32``: no full-scan launch,
   every returned score byte-equal to the full scan's, determinism, v10
   round trip, and for crumb the plain cascade on the CPU over 2 batches;
4d. the paper's Fig. 3: 4-bit, mixed (leading), mixed (v7) and 2-bit
   encodes of its anisotropic 4,000 x 1024 corpus, recall@10 printed;
4e. a corpus wider than one block's butterfly: ``build`` and ``search`` of
   2,000 rows of d=40,000 (d'=65536) on the card against the CPU plain path
   (code flips, ids);
5. time each kernel, its plain version and a one-call PyTorch yardstick
   with CUDA events (medians of one launch per sample; each kernel also as
   the mean of 10 back-to-back launches per sample), beside the bound the
   card could reach (the proxies also at n=1,000,000; the butterfly and the
   proxies, and the proxies' yardstick, also as device time, and with
   ``--parent-csrc`` in turns with the parent's kernels); the 4-bit and 2-bit
   full scans (the 2-bit one on the phase-4c 2-bit index) and the mixed
   scan pair also as device time (CUDA events around back-to-back calls
   queued behind a spin kernel), beside their
   `q_rot @ deq.T` yardstick timed the same three ways, and the 4-bit
   scan's device time at 2 and 3 tiles for each SM; the rescores at m in
   {80, 320} on the cascade's survivors the same three ways beside the
   `bmm` yardstick, the bound and the chain floor (with ``--parent-csrc``,
   a parent's nibble_dot.cu and gather_dot.cu built beside them, and the
   scans and rescores timed in turns through the same wrappers); the
   end-to-end search rate and encode rate; the cascade's rate and batch
   latency beside the full scan, the same for the 2-bit, mixed and v7 full
   scans and their cascades, and at n=1,000,000 (random codes) the batch
   latency of the 4-bit full scan and of each cascade, and of the 2-bit
   full scan; a torch.profiler breakdown of the build and of the eager
   stages of the search, cascade, 2-bit and mixed windows (device time by
   kernel), and each path's graph replay timed by CUDA events (its idle
   share); torch.profiler traces no graph replay, since CUPTI crashed the
   process in one;
6. the engine: every search above ran as a replay of the plan's captured
   CUDA graph.  On every path of phases 4-4e (full scans and cascades, and
   the d=40,000 full scan) the replay is held byte for byte against the
   plan's stages run eagerly at the same bucket, and for b in
   ``ENGINE_BATCHES`` each result against the rows of its full bucket's
   batch and the eager stages on the raw b; on a fresh handle of the index,
   ``searcher(k=10).warmup(64)`` must capture once and the next 10
   searches mint no plan or graph while the launch counters grow by the
   graph's tally each replay; graph and eager batch latency in turns
   (graph, eager, graph, eager) with each one's idle share, at
   45,000 and at 1,000,000 rows; ``torch.cuda.memory_reserved()`` after;
6b. the segmented lifecycle on the card over the phase-4 corpus: add two
   batches of the stand-in, delete ids over all three segments, search the
   full scan and the sign cascade against exact cosine over the live rows
   and the port's plain path on the CPU over the same segments (no
   tombstoned id, every cascade score the full scan's), save v8 and v10,
   reload and search byte-identical, compact into v6, and replay the op
   sequence from a fresh build to equal file hashes; the mutated index's
   full scan and sign cascade pass phase 6's graph and bucketing checks;
   a loop of add + search keeps one graph per plan key and returns the old
   segment set's graph memory;
7. metadata columns, ``where=`` predicates and the IVF backend, after the
   earlier phases' indexes (and their graphs) are dropped.  7a: the phase-4
   corpus with numpy-seeded columns (``lang`` str of 8 values, ``date`` i64
   with int64 min and max planted, ``price`` f64 with -0.0, +0.0, +inf and
   -inf planted) and five predicates (about 12.5%, 1%, 60%, 0% and 60% of
   the rows): the eager mask stage on the card equal to ``evaluate``; the
   filtered full scan and sign_32 (graph replays, launch counters around
   each) byte-equal to the same search with ``Allowlist(evaluate mask)``,
   every id admissible, recall@10 against exact cosine over the admissible
   rows and against the CPU plain path over 2 batches (0.01, 99% of ids); a
   second constant of one structure minting no plan and no graph; v9 and
   v10 save -> load -> search byte-identical; phase 6's graph / eager /
   bucket checks on both filtered paths; all of it again after adding
   2,500 rows with their columns and deleting 500 ids; the filtered paths'
   latency and graph device time in turns with the unfiltered ones.  7b:
   ``build(index="ivf")`` at the reference's nlist=64, train_iters=25: two
   builds write the same bytes; the card's clustering of 8,000 rows against
   the CPU plain one (reported); nprobe 8, 16 and 64: launches (the
   gathered rescore and the butterfly, no full scan), recall against exact
   and against the CPU plain search of the card-built file, probe sets
   compared, and at nprobe = nlist every score byte-equal to the full
   scan's; a 2-bit IVF at nprobe 16 (B5); ``where=`` on IVF; phase 6's
   checks at nprobe 8; mixed traffic (full, filtered full, IVF nprobe 8 and
   16, 3 rounds after a warm-up) capturing nothing; IVF latency and graph
   device time at nprobe 8 and 16, B4 and B5 at IVF's candidate width
   beside ``bmm`` and the bound; add 2,500 rows, delete 500 (the merge
   exact, no tombstoned id), v8 round trip, compact; IVF at 1,000,000 rows
   (random codes, 1,024 balanced cells, nprobe 16): timing only.

Launch counters count kernels that ran: a replay adds its graph's tally.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import faulthandler
import gc
import hashlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bandwidth, the non-tensor
# f32 rate and the int8 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12
# The H100 SXM's boost clock: sizes the spin kernel of `device_ms` and the
# rescores' chain floor below.
SM_CLOCK_HZ = 1.98e9
# A dependent f32 FMA issues 4 cycles after the one it waits on.  The
# gathered rescores keep one accumulator per score, so d' FMAs in a row
# bound them from below: a design figure, not the bound.
FMA_LATENCY_CYCLES = 4
# The main path's shapes: the paper's headline cell (AG News, 45K x 1024).
N = 45_000         # corpus rows
DIM = 1024         # embedding width
BIG_N = 1_000_000  # rows of the large scan check
SEED = 0           # data seed
BATCHES = 10       # query batches of 64 on the main path
RESCORE_MULTS = (8, 32)   # cascade budgets: m = rescore_mult * k survivors
BIG_BATCHES = 20   # timed query batches of 64 at n=1,000,000
PERM_SAMPLE = 512  # rotated rows the v7 permutation is taken from (paper_tables.py)
PRECISIONS = ("bits2", "mixed", "v7")   # phase 4c's indexes
CPU_CASCADE_BATCHES = 2   # batches of the CPU plain crumb cascade in phase 4c
ENGINE_BATCHES = (1, 5, 8, 13, 64, 100)   # phase 6's batch sizes (buckets 8 to 128)
LIFECYCLE_ADD = (2500, 2500)   # phase 6b: rows of the stand-in added, in two batches
LIFECYCLE_DELETE = 1000        # phase 6b: ids deleted over all three segments
ADD_LOOP = (5, 500)            # phase 6b: rounds of add + search, rows added a round
ADD_LOOP_SLACK = 64 << 20      # phase 6b: reserved bytes the loop may grow past its codes
WIDE_N, WIDE_DIM = 2000, 40000   # phase 4e: d' = 65536, past one block's butterfly
# Phase 7: metadata columns, where= predicates and the IVF backend.
LANGS = ("en", "de", "fr", "es", "it", "pt", "nl", "sv")   # the str column's 8 values
FILTER_ADD, FILTER_DELETE = 2500, 500   # phase 7: rows added (with meta=), ids deleted
IVF_NLIST, IVF_TRAIN_ITERS = 64, 25     # the reference's build defaults (ivf.py:176-177)
IVF_NPROBES = (8, 16, 64)               # 64 = nlist: every cell, the full scan's scores
IVF_CPU_ROWS = 8000                     # rows of the CPU-against-card clustering check
IVF_BIG_NLIST, IVF_BIG_NPROBE = 1024, 16   # the 1,000,000-row IVF timing

FAILURES: list = []


def say(*parts) -> None:
    print(*parts, flush=True)


def expect(cond: bool, what: str) -> None:
    """Record a failed check; the run goes on so every check is reported,
    and the script exits non-zero at the end."""
    if not cond:
        FAILURES.append(what)
        say(f"FAIL: {what}")


def bound_ms(nbytes: float, ops: float, ops_per_s: float = PEAK_F32_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gathered_bound_ms(torch, cand, d_pad: int, bits: int) -> tuple:
    """(bound ms, what binds, distinct rows) of a gathered rescore of the
    candidates ``cand`` [b, m] (-1: none): the codes of each distinct
    candidate row read once (a row several queries share comes in once),
    the queries and candidates read and the [b, m] scores written; 2 d'
    operations per valid candidate at the f32 rate."""
    b, m = cand.shape
    valid = cand[cand >= 0]
    rows = int(torch.unique(valid).numel())
    bnd, by = bound_ms(nbytes=rows * d_pad * bits / 8 + 4.0 * b * d_pad + 8.0 * b * m
                       + 4 * 2 ** bits, ops=2.0 * int(valid.numel()) * d_pad)
    return bnd, by, rows


def batch_latencies(search, queries, batches: int) -> dict:
    """Closed-loop host-clock latency of ``batches`` searches of 64 (each
    returns numpy on the host, so each ends with the device done), after
    one untimed search that captures the plan's graph if it has none."""
    search(queries[:64])
    lat = []
    for i in range(batches):
        j = i % (len(queries) // 64)
        t0 = time.perf_counter()
        search(queries[64 * j: 64 * (j + 1)])
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return {"qps": 64 * len(lat) / sum(lat), "median_ms": 1e3 * lat[len(lat) // 2],
            "p90_ms": 1e3 * lat[int(0.9 * len(lat)) - 1], "batches": len(lat)}


def profile_window(torch, fn, label: str, top: int = 10) -> dict:
    """Device activity (kernels and copies) over one call of ``fn`` after a
    warm-up call, traced with torch.profiler: time by name, and the busy
    time as the union of the activity intervals over the traced window's
    wall time.  ``fn`` must replay no CUDA graph: with torch 2.11 / CUDA
    12.8, a graph replayed under the profiler's CUPTI tracing crashed the
    process (SIGSEGV in ``CUDAGraph.replay``), so graph paths are traced
    through their eager stages and timed by ``graph_device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("Activity Buffer")]
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in acts):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name: dict = {}
    for e in acts:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"wall_us": wall_us, "device_busy_us": busy_us,
           "idle_share": max(0.0, 1.0 - busy_us / wall_us),
           "ops": [{"name": k, "device_us": t, "count": c} for k, (t, c) in ops]}
    say(f"profile {label}: wall {wall_us:.1f} us (traced), device busy {busy_us:.1f} us, "
        f"idle share {out['idle_share']:.3f}")
    for op in out["ops"]:
        say(f"  {op['device_us']:>10.1f} us  x{op['count']:<4} {op['name'][:90]}")
    return out


def graph_device_ms(torch, index, kw: dict, qs, replays: int = 10) -> float:
    """Device time of one replay of the graph that a search of 64 at k=10
    with ``kw`` runs on ``index``: CUDA events around ``replays``
    back-to-back replays of that graph, captured on a fresh handle of the
    same tensors (the stages, copies and host work outside the graph are
    not in it)."""
    from repro_torch import MonaVec

    fresh = MonaVec(dataclasses.replace(index.backend), index.mut, index.meta)
    fresh.search(qs[:64], k=10, **kw)
    (graph,) = fresh.backend.graphs.values()
    graph.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def same_result(a, b) -> bool:
    return a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


def search_eager(index, qb, bucketed: bool = True, **kw):
    """``index``'s plan for a search of ``qb`` at k=10 with its stages run
    eagerly, no graph: in ``qb``'s bucket, or at the raw batch."""
    from repro_torch import engine

    return engine.search_eager(index.backend, None if index.mut.is_static else index.mut,
                               qb, 10, bucketed=bucketed, meta=index.meta, **kw)


def engine_checks(label: str, index, kw: dict, qs) -> dict:
    """Graph against eager at the bucket, and bucketing: for b in
    ENGINE_BATCHES each result equals the rows of its full bucket's batch
    and the plan's eager stages on the raw b, byte for byte."""
    from repro_torch import engine

    g = index.search(qs[:64], k=10, **kw)
    as_eager = same_result(g, search_eager(index, qs[:64], **kw))
    prefix_ok, raw_ok = [], []
    for b in ENGINE_BATCHES:
        got = index.search(qs[:b], k=10, **kw)
        full = index.search(qs[:engine.shape_bucket(b)], k=10, **kw)
        prefix_ok.append(same_result(got, (full[0][:b], full[1][:b])))
        raw_ok.append(same_result(got, search_eager(index, qs[:b], False, **kw)))
    say(f"engine {label}: graph = eager stages at b=64 {as_eager}; b in {ENGINE_BATCHES}: "
        f"= full-bucket rows {prefix_ok}, = eager raw b {raw_ok}")
    expect(as_eager, f"engine {label}: the graph replay differs from the eager stages")
    expect(all(prefix_ok), f"engine {label}: a bucketed batch differs from its bucket's rows")
    expect(all(raw_ok), f"engine {label}: a bucketed batch differs from the eager raw b")
    return {"graph_equals_eager": as_eager, "prefix": prefix_ok, "raw_b": raw_ok}


def lifecycle_phase(torch, np, dev, corpus, queries, say, expect) -> dict:
    """Phase 6b: the segmented lifecycle on the card over the phase-4 corpus.

    Two replays of one op sequence from a fresh build (add two batches,
    delete ids over all three segments, save v8, enable the sign code, save
    v10, load the v8 file and compact it, save v6) must save files of equal
    hashes; the first replay's index is searched (full scan and sign
    cascade) against exact cosine over the live rows and the port's plain
    path on the CPU over the same segments, and its files reloaded."""
    from repro_torch import MonaVec
    from repro_torch.core import quantize as qz, scoring
    from repro_torch.core.convert import segmented_from_arrays
    from repro_torch.data.synthetic import embedding_corpus
    from repro_torch.kernels import ops

    added = embedding_corpus(SEED + 5, sum(LIFECYCLE_ADD), DIM)
    rm = max(RESCORE_MULTS)
    out: dict = {}

    def replay(td: Path, tag: str):
        index = MonaVec.build(corpus, metric="cosine")
        lo = 0
        for n in LIFECYCLE_ADD:
            index.add(added[lo: lo + n])
            lo += n
        base_n, ids = index.backend.enc.n, index.ids
        seg1, seg2 = ids[base_n: base_n + LIFECYCLE_ADD[0]], ids[base_n + LIFECYCLE_ADD[0]:]
        dead = np.concatenate([ids[:base_n][::base_n // 600][:600], seg1[::10][:200],
                               seg2[::10][:200]])
        n_dead = index.delete(dead)
        files = {}
        files[8] = td / f"{tag}-v8.mvec"
        index.save(str(files[8]))
        index.enable_coarse("sign")
        files[10] = td / f"{tag}-v10.mvec"
        index.save(str(files[10]))
        comp = MonaVec.load(str(files[8]))
        reclaimed = comp.compact()
        files[6] = td / f"{tag}-compact.mvec"
        comp.save(str(files[6]))
        digests = {v: hashlib.sha256(f.read_bytes()).hexdigest() for v, f in files.items()}
        versions = {v: f.read_bytes()[4] for v, f in files.items()}
        return index, comp, dead, n_dead, reclaimed, files, digests, versions

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        td = Path(tdir)
        index, comp, dead, n_dead, reclaimed, files, digests, versions = replay(td, "a")
        again = replay(td, "b")
        same_files = again[6] == digests
        say(f"lifecycle: n_total {index.n_total}, n_live {index.n_live}, deleted {n_dead}, "
            f"{len(index.mut.extras)} extra segments; file versions {versions}; compact "
            f"reclaimed {reclaimed}; replay from a fresh build gives equal sha256: {same_files}")
        expect(n_dead == LIFECYCLE_DELETE and index.n_live == N + sum(LIFECYCLE_ADD) - n_dead,
               "lifecycle: add/delete counts are off")
        expect(versions == {8: 8, 10: 10, 6: 6}, f"lifecycle: saved versions {versions}")
        expect(same_files, "lifecycle: replaying the op sequence gave other file bytes")
        expect(reclaimed == LIFECYCLE_DELETE and comp.mut.is_static, "lifecycle: compact")
        del again

        qt = torch.from_numpy(queries).to(dev)
        rows = torch.cat([torch.from_numpy(corpus), torch.from_numpy(added)]).to(dev)
        exact_scores = scoring.score_f32(qt, rows, "cosine")
        exact_scores[:, torch.from_numpy(dead.astype(np.int64)).to(dev)] = -float("inf")
        exact = scoring.topk(exact_scores, 10)[1].cpu().numpy()   # row == id here
        del rows, exact_scores

        def recall_of(found):
            return float(np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(found, exact)]))

        segs = [(index.backend.enc, index.backend.ids, index.mut.base_tombs)] + [
            (s.enc, s.ids, s.tombs) for s in index.mut.extras]
        full_scores = torch.cat([torch.cat([
            ops.score_packed(qz.encode_query(qt[64 * i: 64 * (i + 1)], e), e)
            for e, _, _ in segs], dim=1) for i in range(BATCHES)])
        cpu = segmented_from_arrays(
            [{"packed": e.packed.cpu().numpy(), "qnorms": e.qnorms.cpu().numpy(),
              "seed": e.seed, "ids": i, "tombs": t} for e, i, t in segs],
            next_ordinal=index.mut.next_ordinal, metric="cosine", bits=4, dim=DIM,
            dim_pad=index.backend.enc.dim_pad, coarse="sign", device="cpu")
        loaded = {v: MonaVec.load(str(files[v])) for v in (8, 10)}
        for label, kw in (("full", {}), (f"sign_{rm}", {"rescore_mult": rm})):
            res = [index.search(queries[64 * i: 64 * (i + 1)], k=10, **kw)
                   for i in range(BATCHES)]
            s_card = np.concatenate([r[0] for r in res])
            i_card = np.concatenate([r[1] for r in res])
            s_cpu, i_cpu = cpu.search(queries, k=10, **kw)
            no_dead = not np.isin(i_card, dead).any() and bool((i_card < index.n_total).all())
            recall, recall_cpu = recall_of(i_card), recall_of(i_cpu)
            same_ids = float(np.mean(i_cpu == i_card))
            scores_equal = (full_scores.gather(1, torch.from_numpy(i_card.astype(np.int64))
                                               .to(dev)).cpu().numpy().tobytes()
                            == s_card.tobytes())
            reload = {}
            for v, li in loaded.items():
                if kw and v == 8:
                    continue
                s3, i3 = li.search(queries[:64], k=10, **kw)
                reload[v] = s3.tobytes() == res[0][0].tobytes() and \
                    i3.tobytes() == res[0][1].tobytes()
            say(f"lifecycle {label}: recall@10 {recall:.4f} vs exact over the live rows; CPU "
                f"plain path over the same segments recall@10 {recall_cpu:.4f}, ids equal in "
                f"{same_ids:.4%} of slots; no tombstoned id returned: {no_dead}; scores "
                f"byte-equal to the full scan's: {scores_equal}; save -> load -> search "
                f"byte-identical (by version): {reload}")
            expect(no_dead, f"lifecycle {label}: a tombstoned or unknown id was returned")
            expect(abs(recall - recall_cpu) <= 0.01, f"lifecycle {label}: recall vs the CPU")
            expect(same_ids >= 0.99, f"lifecycle {label}: ids differ from the CPU in over 1%")
            expect(scores_equal, f"lifecycle {label}: a score differs from the full scan's")
            expect(all(reload.values()), f"lifecycle {label}: a file round trip differs")
            out[label] = {"recall_at_10": recall, "recall_at_10_cpu": recall_cpu,
                          "ids_equal_cpu": same_ids, "no_tombstoned_id": no_dead,
                          "scores_equal_full_scan": scores_equal, "reload": reload}
        # The mutated index through phase 6's checks: graph = eager stages,
        # and every b equal to its bucket's rows and to the eager raw b.
        for label, kw in (("full", {}), (f"sign_{rm}", {"rescore_mult": rm})):
            out[f"engine_{label}"] = engine_checks(f"mutated {label}", index, kw, queries)

        c_ids = np.concatenate([comp.search(queries[64 * i: 64 * (i + 1)], k=10)[1]
                                for i in range(BATCHES)])
        c_recall = recall_of(c_ids)
        say(f"lifecycle compacted: {comp.n_total} rows in one segment, recall@10 "
            f"{c_recall:.4f}, no tombstoned id returned: {not np.isin(c_ids, dead).any()}")
        expect(not np.isin(c_ids, dead).any(), "lifecycle: the compacted index returned a "
                                               "deleted id")
        out.update(n_total=index.n_total, n_live=index.n_live, deleted=n_dead,
                   versions=versions, sha256=digests, replay_equal=same_files,
                   compact={"reclaimed": reclaimed, "recall_at_10": c_recall})

        # A serving loop of add() then search (full scan and sign cascade):
        # the index keeps one graph per plan key, over its current segments,
        # and the old segment set's graphs give their memory back.
        rounds, per_round = ADD_LOOP
        more = embedding_corpus(SEED + 6, rounds * per_round, DIM)
        stored, reserved = [], []
        for r in range(rounds):
            index.add(more[r * per_round: (r + 1) * per_round])
            for kw in ({}, {"rescore_mult": rm}):
                index.search(queries[:64], k=10, **kw)
            stored.append(len(index.backend.graphs))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved())
        codes = (rounds - 1) * per_round * (index.backend.enc.packed.shape[1] + 4
                                            + index.backend.enc.ccodes.shape[1])
        grown = reserved[-1] - reserved[0]
        say(f"lifecycle add loop: {rounds} rounds of add({per_round}) + full and sign_{rm} "
            f"searches: graphs held {stored}; memory_reserved {[x >> 20 for x in reserved]} "
            f"MiB, grown {grown / 2**20:.1f} MiB past the first round (codes added after it "
            f"{codes / 2**20:.1f} MiB)")
        expect(stored == [2] * rounds, "lifecycle add loop: the index kept graphs of an "
                                       "older segment set")
        expect(grown <= codes + ADD_LOOP_SLACK, "lifecycle add loop: card memory grew past "
                                                "the codes added")
        out["add_loop"] = {"graphs_held": stored, "reserved_bytes": reserved,
                           "codes_bytes": codes}
        del index, comp, loaded, cpu, full_scores
    return out


def filter_ivf_phase(c) -> dict:
    """Phase 7: metadata columns and where= predicates on the phase-4 corpus
    (full scan and sign cascade, static and after add + delete), the IVF
    backend at the reference's defaults, mixed traffic through the graphs,
    and their timing.  ``c`` carries the main phase's tensors and helpers."""
    torch, np, dev = c.torch, c.np, c.dev
    from repro_torch import MonaVec, engine
    from repro_torch.core import ivf as ivf_mod, lloydmax, predicate as pr, quantize as qz
    from repro_torch.core import scoring
    from repro_torch.core.allowlist import Allowlist
    from repro_torch.core.convert import ivf_from_arrays, segmented_from_arrays
    from repro_torch.core.metadata import MetaStore
    from repro_torch.core.predicate import Eq, Ge, Gt, In, Lt, Ne
    from repro_torch.core.segments import SENTINEL_ID
    from repro_torch.data.synthetic import embedding_corpus
    from repro_torch.kernels import ops

    corpus, queries, expect, say = c.corpus, c.queries, c.expect, c.say
    rm = max(RESCORE_MULTS)
    cpu_q = 64 * CPU_CASCADE_BATCHES          # queries of every CPU plain comparison
    out: dict = {}
    rng = np.random.default_rng(SEED + 7)
    i64 = np.iinfo(np.int64)

    def columns(n: int) -> dict:
        return {"lang": np.array(LANGS)[rng.integers(0, len(LANGS), n)],
                "date": rng.integers(0, 1_000_000, n), "price": rng.standard_normal(n)}

    cols = columns(N)
    cols["date"][:2] = [i64.min, i64.max]
    cols["price"][2:6] = [-0.0, 0.0, np.inf, -np.inf]
    preds = {"eq_lang": Eq("lang", "en"),                                  # ~12.5%
             "lang_date": Eq("lang", "en") & Lt("date", 80_000),           # ~1%
             "price_or_lang": Ge("price", 0.0) | In("lang", ["de", "fr"]),  # ~60%
             "none": Gt("price", np.inf),                                  # 0%
             "not_in": ~In("lang", ["es", "it", "pt"]) & Ne("date", int(i64.max))}
    second = Eq("lang", "en") & Lt("date", 400_000)                        # ~5%
    added = embedding_corpus(SEED + 8, FILTER_ADD, DIM)
    added_cols = columns(FILTER_ADD)
    qt = torch.from_numpy(queries).to(dev)
    rows_t = torch.cat([torch.from_numpy(corpus), torch.from_numpy(added)]).to(dev)
    exact_all = scoring.score_f32(qt, rows_t, "cosine")      # [640, N + FILTER_ADD]
    del rows_t

    def exact_ids(mask: np.ndarray) -> np.ndarray:
        """Exact f32 cosine top-10 over the admissible rows (row == id)."""
        s = exact_all[:, :mask.shape[0]].clone()
        s[:, ~torch.from_numpy(mask).to(dev)] = -float("inf")
        return scoring.topk(s, 10)[1].cpu().numpy()

    def recall(found: np.ndarray, exact: np.ndarray) -> float:
        return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10.0
                              for a, b in zip(found, exact)]))

    def run(index, kw: dict, batches: int = BATCHES):
        res = [index.search(queries[64 * i: 64 * (i + 1)], k=10, **kw) for i in range(batches)]
        return np.concatenate([r[0] for r in res]), np.concatenate([r[1] for r in res])

    def same(a, b) -> bool:
        return a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()

    def launched(fn):
        c.reset_counts()
        torch.cuda.synchronize()
        got = fn()
        torch.cuda.synchronize()
        return got, c.read_counts()

    def device_mask(index, p) -> np.ndarray:
        """The predicate_mask stage run eagerly on the card, as the plan runs it."""
        store, args = index.meta, []
        for col, key in zip(pr.leaf_columns(p), pr.constant_keys(p, store)):
            args += [store[col].on(dev), torch.from_numpy(np.array(key)).to(dev)]
        live = torch.ones(store.n_rows, dtype=torch.bool, device=dev)
        return pr.build_stage_fn(p)(live, *args).cpu().numpy()

    def cpu_twin(index, coarse=None):
        """The port's plain path on the CPU over the same segments and columns."""
        e0 = index.backend.enc
        segs = [{"packed": e.packed.cpu().numpy(), "qnorms": e.qnorms.cpu().numpy(),
                 "seed": e.seed, "ids": i, "tombs": t}
                for e, i, t in [(e0, index.backend.ids, index.mut.base_tombs)]
                + [(s.enc, s.ids, s.tombs) for s in index.mut.extras]]
        return segmented_from_arrays(segs, next_ordinal=index.mut.next_ordinal,
                                     metric="cosine", bits=e0.bits, dim=DIM,
                                     dim_pad=e0.dim_pad, coarse=coarse, meta=index.meta,
                                     device="cpu")

    # ---- 7a. filtered search ------------------------------------------------
    t_phase = time.perf_counter()
    fflat = MonaVec.build(corpus, meta=cols)
    fsign = MonaVec.build(corpus, meta=cols, coarse="sign")
    paths = {"full": ({}, ("fwht", "nibble_dot"), ()),
             f"sign_{rm}": ({"rescore_mult": rm}, ("fwht", "sign_hamming", "gather_nibble_dot"),
                            ("nibble_dot",))}

    def filtered_checks(tag: str, td: Path) -> dict:
        n_total = fflat.n_total
        alive = np.concatenate([~fflat.mut.base_tombs] + [~s.tombs for s in fflat.mut.extras])
        cpu = {"full": cpu_twin(fflat), f"sign_{rm}": cpu_twin(fsign, "sign")}
        res: dict = {}
        for name, p in preds.items():
            mask = pr.evaluate(p, fflat.meta)
            mask_ok = (np.array_equal(device_mask(fflat, p), mask)
                       and np.array_equal(device_mask(fsign, p), mask))
            expect(mask_ok, f"filter {tag} {name}: the device mask differs from evaluate")
            exact = exact_ids(mask & alive)
            entry = {"selectivity": float(mask.mean()), "mask_equals_evaluate": mask_ok}
            for label, (kw, ran, not_ran) in paths.items():
                index = fflat if label == "full" else fsign
                (s_card, i_card), got = launched(lambda: run(index, {"where": p, **kw}))
                oracle = run(index, {"allow": Allowlist(mask=mask, n_allowed=int(mask.sum())),
                                     **kw})
                real = i_card[i_card != SENTINEL_ID].astype(np.int64)
                admissible = bool((real < n_total).all() and (mask & alive)[real].all())
                kernels_ok = (all(got[k] > 0 for k in ran)
                              and all(got[k] == 0 for k in not_ran))
                e = {"launches": got, "oracle_bytes_equal": same((s_card, i_card), oracle),
                     "admissible": admissible}
                expect(e["oracle_bytes_equal"], f"filter {tag} {name} {label}: not the "
                                                "allowlist oracle's bytes")
                expect(admissible, f"filter {tag} {name} {label}: an inadmissible id came back")
                expect(kernels_ok, f"filter {tag} {name} {label}: launches {got}")
                if name == "none":
                    e["all_sentinel"] = bool((i_card == SENTINEL_ID).all())
                    expect(e["all_sentinel"], f"filter {tag} none {label}: a row came back")
                else:
                    s_cpu, i_cpu = cpu[label].search(queries[:cpu_q], k=10, where=p, **kw)
                    e.update(recall_at_10=recall(i_card, exact),
                             recall_at_10_card_cpu_queries=recall(i_card[:cpu_q], exact),
                             recall_at_10_cpu=recall(i_cpu, exact),
                             ids_equal_cpu=float(np.mean(i_cpu == i_card[:cpu_q])))
                    expect(abs(e["recall_at_10_card_cpu_queries"] - e["recall_at_10_cpu"])
                           <= 0.01, f"filter {tag} {name} {label}: recall vs the CPU")
                    expect(e["ids_equal_cpu"] >= 0.99,
                           f"filter {tag} {name} {label}: ids differ from the CPU in over 1%")
                found = ("every slot a sentinel " + str(e["all_sentinel"]) if name == "none"
                         else f"recall@10 {e['recall_at_10']:.4f} vs exact over the admissible "
                              f"rows; on the {cpu_q} CPU queries card "
                              f"{e['recall_at_10_card_cpu_queries']:.4f} CPU plain "
                              f"{e['recall_at_10_cpu']:.4f}, ids equal {e['ids_equal_cpu']:.4%}")
                say(f"filter {tag} {name} ({entry['selectivity']:.2%} of rows) {label}: mask = "
                    f"evaluate {mask_ok}; = allowlist oracle {e['oracle_bytes_equal']}; "
                    f"admissible {admissible}; {found}; launches {got}")
                entry[label] = e
            res[name] = entry
        # Another constant of one structure: no new plan, no capture.
        cache = engine.plan_cache()
        before = cache.stats.snapshot()
        for label, (kw, _, _) in paths.items():
            index = fflat if label == "full" else fsign
            mask = pr.evaluate(second, index.meta)
            got = run(index, {"where": second, **kw})
            want = run(index, {"allow": Allowlist(mask=mask, n_allowed=int(mask.sum())), **kw})
            expect(same(got, want), f"filter {tag} second constant {label}: not the oracle's")
        delta = cache.stats.since(before)
        share = float(pr.evaluate(second, fflat.meta).mean())
        say(f"filter {tag}: a second constant ({share:.2%} of rows) of the lang_date "
            f"structure, and its oracle: {delta.misses} new plans, {delta.captures} captures")
        expect(delta.misses == 0 and delta.captures == 0,
               f"filter {tag}: a second constant minted a plan or captured a graph")
        res["second_constant"] = {"misses": delta.misses, "captures": delta.captures}
        # v9 (columns) and v10 (columns and coarse codes): save -> load -> search.
        files = {}
        for index, kw, version in ((fflat, {}, 9), (fsign, {"rescore_mult": rm}, 10)):
            path = td / f"{tag}-v{version}.mvec"
            index.save(str(path))
            back = MonaVec.load(str(path))
            p = preds["lang_date"]
            files[version] = (path.read_bytes()[4] == version and same(
                back.search(queries[:64], k=10, where=p, **kw),
                index.search(queries[:64], k=10, where=p, **kw)))
            expect(files[version], f"filter {tag}: v{version} save -> load -> search differs")
            del back
        say(f"filter {tag}: save -> load -> search byte-identical (by version): {files}")
        res["files"] = files
        return res

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        td = Path(tdir)
        out["filter_static"] = filtered_checks("static", td)
        out["engine_filtered_full"] = engine_checks("filtered full", fflat,
                                                      {"where": preds["eq_lang"]}, queries)
        out["engine_filtered_sign"] = engine_checks(
            f"filtered sign_{rm}", fsign, {"where": preds["eq_lang"], "rescore_mult": rm},
            queries)
        # 7c: the filtered paths against their unfiltered runs, in turns.
        timing: dict = {}
        p = preds["eq_lang"]
        for label, index, kw in (("full", fflat, {}), (f"sign_{rm}", fsign, {"rescore_mult": rm})):
            runs = {"plain": [], "filtered": []}
            for mode in ("plain", "filtered", "plain", "filtered"):
                kwm = dict(kw, where=p) if mode == "filtered" else kw
                runs[mode].append(batch_latencies(
                    lambda qb: index.search(qb, k=10, **kwm), queries, 100))
            entry = {}
            for mode in runs:
                kwm = dict(kw, where=p) if mode == "filtered" else kw
                dev_ms = graph_device_ms(torch, index, kwm, queries)
                lat = runs[mode]
                entry[mode] = {"latency": lat, "graph_device_ms": dev_ms,
                               "idle_share_estimate": max(0.0, 1 - dev_ms / lat[0]["median_ms"])}
            say(f"filter timing {label} (eq_lang) in turns unfiltered / filtered / unfiltered / "
                f"filtered: batch median {runs['plain'][0]['median_ms']:.4f} / "
                f"{runs['filtered'][0]['median_ms']:.4f} / {runs['plain'][1]['median_ms']:.4f} / "
                f"{runs['filtered'][1]['median_ms']:.4f} ms, p90 "
                f"{runs['plain'][0]['p90_ms']:.4f} / {runs['filtered'][0]['p90_ms']:.4f} / "
                f"{runs['plain'][1]['p90_ms']:.4f} / {runs['filtered'][1]['p90_ms']:.4f} ms; "
                f"graph device {entry['plain']['graph_device_ms']:.4f} / "
                f"{entry['filtered']['graph_device_ms']:.4f} ms; idle share estimate "
                f"{entry['plain']['idle_share_estimate']:.3f} / "
                f"{entry['filtered']['idle_share_estimate']:.3f}")
            timing[f"filtered_{label}"] = entry
        out["timing"] = timing

        # Add rows with their columns, delete ids over both segments: every
        # check again.
        for index in (fflat, fsign):
            index.add(added, meta=added_cols)
        ids = fflat.ids
        dead = ids[::(N + FILTER_ADD) // FILTER_DELETE][:FILTER_DELETE]
        n_dead = [index.delete(dead) for index in (fflat, fsign)]
        expect(n_dead == [FILTER_DELETE] * 2, f"filter: deleted {n_dead}")
        out["filter_mutated"] = filtered_checks("mutated", td)
    say(f"phase 7a: {time.perf_counter() - t_phase:.1f} s")

    # ---- 7b. IVF --------------------------------------------------------------
    t_phase = time.perf_counter()
    ivf_kw = {"index": "ivf", "nlist": IVF_NLIST, "train_iters": IVF_TRAIN_ITERS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = MonaVec.build(corpus, **ivf_kw)
    torch.cuda.synchronize()
    ivf_build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        td = Path(tdir)
        ivf.save(str(td / "a.mvec"))
        MonaVec.build(corpus, **ivf_kw).save(str(td / "b.mvec"))
        builds_equal = (td / "a.mvec").read_bytes() == (td / "b.mvec").read_bytes()
        cpu_ivf = MonaVec.load(str(td / "a.mvec"), device="cpu")
    be = ivf.backend
    cells = np.diff(be.offsets)
    say(f"ivf build {N}x{DIM} nlist={IVF_NLIST} train_iters={IVF_TRAIN_ITERS}: "
        f"{ivf_build_s:.3f} s; cells min {cells.min()} median {int(np.median(cells))} max "
        f"{cells.max()}; two card builds give byte-identical files: {builds_equal}")
    expect(builds_equal, "ivf: two card builds wrote different files")

    def assignment(b) -> np.ndarray:
        a = np.empty(b.enc.n, dtype=np.int64)
        a[b.order] = np.repeat(np.arange(b.nlist), np.diff(b.offsets))
        return a

    card8 = MonaVec.build(corpus[:IVF_CPU_ROWS], **ivf_kw).backend
    cpu8 = MonaVec.build(corpus[:IVF_CPU_ROWS], device="cpu", **ivf_kw).backend
    cent_diff = float((card8.centroids.cpu() - cpu8.centroids).abs().max())
    agree = float(np.mean(assignment(card8) == assignment(cpu8)))
    say(f"ivf clustering of the first {IVF_CPU_ROWS} rows, card against CPU plain: centroid "
        f"max|diff| {cent_diff:.3e}, assignments equal for {agree:.4%} of rows (reported)")
    out["ivf_build"] = {"seconds": ivf_build_s, "builds_equal": builds_equal,
                        "cells": [int(cells.min()), int(np.median(cells)), int(cells.max())],
                        "cpu_rows": IVF_CPU_ROWS, "centroid_max_abs_diff": cent_diff,
                        "assignment_agreement": agree}
    del card8, cpu8

    exact = exact_ids(np.ones(N, dtype=bool))
    full_scores = torch.cat([ops.score_packed(qz.encode_query(qt[64 * i: 64 * (i + 1)], be.enc),
                                              be.enc) for i in range(BATCHES)])
    out["ivf"] = {}
    for nprobe in IVF_NPROBES:
        (s_card, i_card), got = launched(lambda: run(ivf, {"nprobe": nprobe}))
        kernels_ok = (got["gather_nibble_dot"] > 0 and got["fwht"] > 0
                      and got["nibble_dot"] == 0)
        s_cpu, i_cpu = cpu_ivf.search(queries[:cpu_q], k=10, nprobe=nprobe)
        probes = []
        for q_in, b_ in ((qt[:cpu_q], be),
                         (torch.from_numpy(queries[:cpu_q]), cpu_ivf.backend)):
            cs = ivf_mod.probe_scores(qz.encode_query(q_in, b_.enc), b_.centroids, "cosine")
            probes.append(np.sort(scoring.topk(cs, nprobe)[1].cpu().numpy(), axis=1))
        probe_diff = int((probes[0] != probes[1]).any(axis=1).sum())
        e = {"launches": got, "recall_at_10": recall(i_card, exact),
             "recall_at_10_card_cpu_queries": recall(i_card[:cpu_q], exact),
             "recall_at_10_cpu": recall(i_cpu, exact),
             "ids_equal_cpu": float(np.mean(i_cpu == i_card[:cpu_q])),
             "probe_sets_differing": probe_diff, "max_candidates": be.max_candidates(nprobe)}
        if nprobe == IVF_NLIST:
            e["scores_equal_full_scan"] = (full_scores.gather(1, torch.from_numpy(
                i_card.astype(np.int64)).to(dev)).cpu().numpy().tobytes() == s_card.tobytes())
            expect(e["scores_equal_full_scan"], "ivf: at nprobe=nlist a score differs from "
                                                "the full scan's")
        say(f"ivf nprobe={nprobe} (max_cand {e['max_candidates']}): recall@10 "
            f"{e['recall_at_10']:.4f} vs exact; on the {cpu_q} CPU queries card "
            f"{e['recall_at_10_card_cpu_queries']:.4f} CPU plain (card-built file) "
            f"{e['recall_at_10_cpu']:.4f}, ids equal {e['ids_equal_cpu']:.4%}, probe sets "
            f"differing {probe_diff}; scores = full scan's "
            f"{e.get('scores_equal_full_scan', 'n/a')}; launches {got}")
        expect(kernels_ok, f"ivf nprobe={nprobe}: launches {got}")
        expect(abs(e["recall_at_10_card_cpu_queries"] - e["recall_at_10_cpu"]) <= 0.01,
               f"ivf nprobe={nprobe}: recall vs the CPU plain path")
        expect(e["ids_equal_cpu"] >= 0.99, f"ivf nprobe={nprobe}: ids differ from the CPU "
                                           "in over 1%")
        out["ivf"][nprobe] = e
    del full_scores, cpu_ivf

    ivf2 = MonaVec.build(corpus, bits=2, **ivf_kw)
    (s2, i2), got = launched(lambda: run(ivf2, {"nprobe": 16}))
    out["ivf_2bit"] = {"launches": got, "recall_at_10": recall(i2, exact)}
    say(f"ivf 2-bit nprobe=16: recall@10 {out['ivf_2bit']['recall_at_10']:.4f}; launches {got}")
    expect(got["gather_crumb_dot"] > 0 and got["crumb_dot"] == 0 and got["fwht"] > 0,
           f"ivf 2-bit: launches {got}")

    # IVF with where=, on the same lists (a handle sharing the backend).
    ivfm = MonaVec(ivf.backend, meta=MetaStore.build(cols, N))
    for name in ("eq_lang", "price_or_lang"):
        p = preds[name]
        mask = pr.evaluate(p, ivfm.meta)
        s_f, i_f = run(ivfm, {"nprobe": 16, "where": p})
        oracle = run(ivfm, {"nprobe": 16, "allow": Allowlist(mask=mask,
                                                              n_allowed=int(mask.sum()))})
        real = i_f[i_f != SENTINEL_ID].astype(np.int64)
        ok = bool(mask[real].all()) and same((s_f, i_f), oracle)
        say(f"ivf nprobe=16 where={name}: only admissible ids, = allowlist oracle: {ok}")
        expect(ok, f"ivf where={name}: an inadmissible id or not the oracle's bytes")
    out["engine_ivf"] = engine_checks("ivf nprobe=8", ivf, {"nprobe": 8}, queries)

    # Mixed traffic through one index each: no capture after the warm-up.
    mixed = [(fflat, {}), (fflat, {"where": preds["eq_lang"]}), (ivf, {"nprobe": 8}),
             (ivf, {"nprobe": 16})]
    qb = queries[:64]
    for index, kw in mixed:
        index.search(qb, k=10, **kw)
    cache = engine.plan_cache()
    before = cache.stats.snapshot()
    for _ in range(3):
        for index, kw in mixed:
            index.search(qb, k=10, **kw)
    delta = cache.stats.since(before)
    out["mixed_traffic"] = {"captures": delta.captures, "misses": delta.misses,
                            "graphs_held": [len(fflat.backend.graphs), len(ivf.backend.graphs)]}
    say(f"mixed traffic (full, filtered full, ivf nprobe 8, ivf nprobe 16) x 3 after a warm-up: "
        f"captures {delta.captures}, new plans {delta.misses}; graphs held "
        f"{out['mixed_traffic']['graphs_held']}")
    expect(delta.captures == 0 and delta.misses == 0, "mixed traffic recaptured a graph")

    # 7c: IVF latency, and the rescores at IVF's candidate width.
    for nprobe in (8, 16):
        lat = batch_latencies(lambda qb_: ivf.search(qb_, k=10, nprobe=nprobe), queries, 100)
        dev_ms = graph_device_ms(torch, ivf, {"nprobe": nprobe}, queries)
        out["timing"][f"ivf_{nprobe}"] = {"latency": lat, "graph_device_ms": dev_ms,
                                          "idle_share_estimate":
                                          max(0.0, 1 - dev_ms / lat["median_ms"])}
        say(f"ivf timing nprobe={nprobe}: batch median {lat['median_ms']:.4f} ms p90 "
            f"{lat['p90_ms']:.4f} ms, {lat['qps']:.1f} queries/s; graph device {dev_ms:.4f} ms; "
            f"idle share estimate {max(0.0, 1 - dev_ms / lat['median_ms']):.3f}")
    d_pad = be.enc.dim_pad
    for bits, index, nprobes, kernel in ((4, ivf, (8, 16), c.gather_nibble_dot_cuda),
                                         (2, ivf2, (16,), c.gather_crumb_dot_cuda)):
        b_ = index.backend
        q_rot = qz.encode_query(qt[:64], b_.enc).contiguous()
        for nprobe in nprobes:
            m = b_.max_candidates(nprobe)
            probe = scoring.topk(ivf_mod.probe_scores(q_rot, b_.centroids, "cosine"), nprobe)[1]
            cand = ivf_mod.candidates(probe, b_.order_t, b_.offsets_t, max(m, 10))
            cand32 = cand.to(torch.int32).contiguous()
            unpack = qz.unpack_4bit if bits == 4 else qz.unpack_2bit
            rows_f32 = lloydmax.dequantize(unpack(b_.enc.packed[cand.clamp(min=0)]), bits)
            run_k = lambda: kernel(b_.enc.packed, q_rot, cand32)
            bmm = lambda: torch.bmm(rows_f32, q_rot[:, :, None])
            n_valid = int((cand >= 0).sum())
            bnd, by, n_rows = gathered_bound_ms(torch, cand32, d_pad, bits)
            e = {"m": m, "valid_candidates": n_valid, "distinct_rows": n_rows,
                 "kernel": c.time_ms(run_k),
                 "b2b": c.time_ms(run_k, reps=c.B2B), "device_ms": c.device_ms(run_k),
                 "library": c.time_ms(bmm), "library_device_ms": c.device_ms(bmm),
                 "bound_ms": bnd, "bound_by": by}
            say(f"rescore {kernel.__name__} at ivf nprobe={nprobe} (b=64, m={m}, "
                f"{n_valid} valid, {n_rows} distinct rows): one launch {e['kernel']['median']:.4f} ms, back-to-back "
                f"{e['b2b']['median']:.4f} ms, device {e['device_ms']:.4f} ms "
                f"({bnd / e['device_ms']:.1%} of the bound); bmm of the pre-gathered rows "
                f"{e['library']['median']:.4f} / {e['library_device_ms']:.4f} ms; bound "
                f"{bnd:.4f} ms ({by})")
            out["timing"][f"rescore_{bits}bit_ivf_{nprobe}"] = e
            del rows_f32, bmm
    del ivf2
    torch.cuda.empty_cache()

    # The IVF lifecycle: add rows, delete ids, search (the extras merged),
    # v8 round trip, compact.
    ivf.add(added)
    ivf_ids = ivf.ids
    dead = ivf_ids[::(N + FILTER_ADD) // FILTER_DELETE][:FILTER_DELETE]
    n_dead = ivf.delete(dead)
    (s_m, i_m), got = launched(lambda: run(ivf, {"nprobe": 16}))
    no_dead = not np.isin(i_m, dead).any()
    # The merge is exact: no live extra row left out scores above the
    # lowest score returned.
    extra = ivf.mut.extras[0]
    side = torch.cat([ops.score_packed(qz.encode_query(qt[64 * i: 64 * (i + 1)], extra.enc),
                                       extra.enc) for i in range(BATCHES)]).cpu().numpy()
    side[:, extra.tombs] = -np.inf
    returned = np.zeros_like(side, dtype=bool)
    rows_b, cols_b = np.nonzero((i_m >= N) & (i_m != SENTINEL_ID))
    returned[rows_b, (i_m[rows_b, cols_b] - N).astype(np.int64)] = True
    left_out = np.where(returned, -np.inf, side).max(axis=1)
    merged = bool((left_out <= s_m[:, -1]).all()) and bool(returned.any())
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        path = Path(tdir) / "ivf-v8.mvec"
        ivf.save(str(path))
        back = MonaVec.load(str(path))
        v8_ok = path.read_bytes()[4] == 8 and same(back.search(queries[:64], k=10, nprobe=16),
                                                   (s_m[:64], i_m[:64]))
        again = Path(tdir) / "again.mvec"
        back.save(str(again))
        v8_ok = v8_ok and again.read_bytes() == path.read_bytes()
        del back
    reclaimed = ivf.compact()
    c_ids = run(ivf, {"nprobe": 16})[1]
    compact_ok = (reclaimed == FILTER_DELETE and ivf.backend.nlist == IVF_NLIST
                  and ivf.mut.is_static and not np.isin(c_ids, dead).any())
    c_recall = recall(c_ids, exact_ids(~np.isin(np.arange(N + FILTER_ADD), dead)))
    say(f"ivf lifecycle: add {FILTER_ADD}, delete {n_dead}; nprobe=16 launches {got}; no "
        f"tombstoned id {no_dead}; extras merged exactly {merged}; v8 save -> load -> search "
        f"and -> save byte-identical {v8_ok}; compact reclaimed {reclaimed}, "
        f"{ivf.backend.nlist} cells, recall@10 after {c_recall:.4f}")
    expect(n_dead == FILTER_DELETE and no_dead and merged and v8_ok and compact_ok,
           "ivf lifecycle: a check failed")
    expect(got["nibble_dot"] > 0 and got["gather_nibble_dot"] > 0,
           f"ivf lifecycle: launches {got}")
    out["ivf_lifecycle"] = {"deleted": n_dead, "launches": got, "no_tombstoned_id": no_dead,
                            "merged_exactly": merged, "v8_round_trip": v8_ok,
                            "compact_reclaimed": reclaimed, "compact_recall_at_10": c_recall}
    del ivf, ivfm, fflat, fsign, exact_all
    torch.cuda.empty_cache()

    # 7c: IVF at 1,000,000 rows, random codes in balanced random cells: timing only.
    big_rng = np.random.default_rng(SEED + 9)
    cents = big_rng.standard_normal((IVF_BIG_NLIST, DIM), dtype=np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    big = ivf_from_arrays(
        big_rng.integers(0, 256, size=(BIG_N, DIM // 2), dtype=np.uint8),
        np.ones(BIG_N, np.float32), ids=np.arange(BIG_N, dtype=np.uint64), centroids=cents,
        order=big_rng.permutation(BIG_N),
        offsets=np.linspace(0, BIG_N, IVF_BIG_NLIST + 1).astype(np.int64),
        nlist=IVF_BIG_NLIST, seed=SEED, metric="cosine", bits=4, dim=DIM, dim_pad=DIM)
    big_q = big_rng.standard_normal((64 * BATCHES, DIM), dtype=np.float32)
    lat = batch_latencies(lambda qb_: big.search(qb_, k=10, nprobe=IVF_BIG_NPROBE), big_q,
                          BIG_BATCHES)
    dev_ms = graph_device_ms(torch, big, {"nprobe": IVF_BIG_NPROBE}, big_q)
    out["timing"]["ivf_1m"] = {"latency": lat, "graph_device_ms": dev_ms,
                               "max_candidates": big.backend.max_candidates(IVF_BIG_NPROBE)}
    say(f"ivf n={BIG_N} nlist={IVF_BIG_NLIST} nprobe={IVF_BIG_NPROBE} (m "
        f"{big.backend.max_candidates(IVF_BIG_NPROBE)}): batch median {lat['median_ms']:.4f} ms "
        f"p90 {lat['p90_ms']:.4f} ms over {lat['batches']} batches of 64; graph device "
        f"{dev_ms:.4f} ms")
    del big
    torch.cuda.empty_cache()
    say(f"phase 7b: {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the full report here")
    ap.add_argument("--parent-csrc", default=None,
                    help="a directory holding another commit's nibble_dot.cu, gather_dot.cu, "
                         "hadamard.cu and binary_dot.cu: build them, hold the full scans, the "
                         "butterfly and the proxies byte for byte against them and time the "
                         "kernels in turns with these")
    args = ap.parse_args()
    faulthandler.enable()     # a crash in native code names its Python line

    import torch

    # ---- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import MonaVec, engine, obs
    from repro_torch.core import binary, lloydmax, quantize as qz, rhdh, scoring, standardize
    from repro_torch.core.bruteforce import BruteForceIndex
    from repro_torch.data.synthetic import embedding_corpus, queries_from_corpus
    from repro_torch.kernels import (binary_dot, cuda_build, gather_dot, hadamard, nibble_dot,
                                     ops, ref)
    from repro_torch.kernels.binary_dot import crumb_affinity_cuda, sign_hamming_cuda
    from repro_torch.kernels.gather_dot import gather_crumb_dot_cuda, gather_nibble_dot_cuda
    from repro_torch.kernels.nibble_dot import crumb_dot_cuda, nibble_dot_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # The host CPU picks the kernels of the CPU plain paths compared against
    # below (ROADMAP C item 2).
    cpu_model = next((line.split(":", 1)[1].strip() for line in
                      Path("/proc/cpuinfo").read_text().splitlines()
                      if line.startswith("model name")), "unknown")
    say(f"host CPU {cpu_model}, torch CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads")
    report: dict = {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                    "host_cpu": cpu_model}

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build(["hadamard", "nibble_dot", "binary_dot", "gather_dot"])
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        say(f"build {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                say(f"  {line.strip()}")
    say(f"build total: {build_s:.2f} s")
    report["build_s"] = build_s
    # With --parent-csrc, the parent's sources are built beside these (one
    # nvcc each, in parallel) and bound to the same wrappers by
    # `parent_kernels()`, so the two differ only on the card.
    sources = {"nibble_dot": (nibble_dot, ("nibble_dot", "crumb_dot")),
               "gather_dot": (gather_dot, ("gather_nibble_dot", "gather_crumb_dot")),
               "hadamard": (hadamard, ("fwht_rows",)),
               "binary_dot": (binary_dot, ("sign_hamming", "crumb_affinity"))}
    parent_entries = {}
    if args.parent_csrc:
        procs = {}
        for source in sources:
            lib_path = ROOT / "build" / f"lib{source}_parent.so"
            procs[source] = (subprocess.Popen(
                [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path),
                 str(Path(args.parent_csrc) / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib_path)
        for source, (proc, lib_path) in procs.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the parent's {source}.cu:\n{log}")
            parent_lib = ctypes.CDLL(str(lib_path))
            module, names = sources[source]
            for fn_name in names:
                entry = getattr(parent_lib, fn_name)
                entry.argtypes, entry.restype = module._ARGTYPES, ctypes.c_int
                parent_entries[fn_name] = (module, entry)
        say(f"built the parent's {', '.join(f'{s}.cu' for s in sources)} from "
            f"{args.parent_csrc}")

    @contextlib.contextmanager
    def parent_kernels():
        """The kernel wrappers launch the parent's kernels inside (same host
        path, so the two differ only on the card)."""
        for module, names in sources.values():
            module._entry(names[0])
        saved = {name: module._ENTRY[name] for name, (module, _) in parent_entries.items()}
        for name, (module, entry) in parent_entries.items():
            module._ENTRY[name] = entry
        try:
            yield
        finally:
            for name, (module, _) in parent_entries.items():
                module._ENTRY[name] = saved[name]

    def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
        """Equal shapes, dtypes and bytes (so +0.0 and -0.0 differ)."""
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return bool(torch.equal(a, b))

    def same_as_parent(fn, *args) -> bool:
        """``fn(*args)`` gives the bytes the parent's kernel gives."""
        got = fn(*args)
        with parent_kernels():
            want = fn(*args)
        return same_bytes(got, want)

    # ---- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED + 1)
    fwht_err = {}

    def check_fwht(n: int, d: int, offset: int = 0) -> float:
        """The butterfly kernel byte for byte against its stage-order plain
        version, within tolerance of the Kronecker one and, with
        --parent-csrc, byte for byte against the parent's kernel wherever
        it takes d'.  ``offset`` floats shift x off 16-byte alignment."""
        d_pad = rhdh.next_pow2(d)
        flat = torch.from_numpy(rng.standard_normal(n * d + offset, dtype=np.float32)).to(dev)
        x = flat[offset:].view(n, d)
        signs = rhdh.rademacher_signs(1234 + d, d_pad, dev)
        got = hadamard.fwht_cuda(x, signs, d_pad)
        same = same_bytes(got, hadamard.signed_fwht_butterfly(x, signs, d_pad))
        want = hadamard.signed_fwht_plain(x, signs, d_pad)
        torch.cuda.synchronize()
        # Both sum the same +-x_i in another order: a per-row bound in ||x||_1.
        tol = 1e-5 * x.abs().sum(dim=1, keepdim=True) + 1e-6
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
        worst = float(err.max())
        parent = ""
        if parent_entries and d_pad <= 32768:
            as_parent = same_as_parent(hadamard.fwht_cuda, x, signs, d_pad)
            parent = f"; byte-equal to the parent's kernel: {as_parent}"
            expect(as_parent, f"fwht kernel differs from the parent's at n={n} d={d}")
        say(f"fwht   n={n:>6} d={d:>7} d'={d_pad:>7}{' off 16 B' if offset else ''}: byte-equal "
            f"to the butterfly {same}; vs Kronecker max|err|={worst:.3e} (tol "
            f"1e-5*|x|_1+1e-6) {'ok' if ok else 'MISMATCH'}{parent}")
        expect(same, f"fwht kernel is not byte-equal to the butterfly at n={n} d={d}")
        expect(ok, f"fwht kernel disagrees at n={n} d={d}")
        return worst

    # Every single-pass instance (d' = 2^0 .. 2^15) and the two-pass form,
    # d whole and ragged, rows aligned and not.
    for log_d in range(18):
        d_pad = 1 << log_d
        for d in sorted({d_pad, d_pad // 2 + 1 + d_pad // 5}):
            check_fwht(33, d)
        check_fwht(33, d_pad, offset=1)
    for n, d in [(1000, 5), (1000, 16), (4096, 1000), (1024, 4096), (64, 32768), (64, 40000),
                 (16, 131072), (4, 1 << 20), (2, 1 << 21)]:
        check_fwht(n, d)
    fwht_err["main"] = check_fwht(N, DIM)

    deq_table = torch.tensor(lloydmax.CENTROIDS_4BIT, device=dev)

    def check_scan(b: int, n: int, d_pad: int) -> tuple:
        packed = torch.from_numpy(
            rng.integers(0, 256, size=(n, d_pad // 2), dtype=np.uint8)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, d_pad), dtype=np.float32)).to(dev)
        got = nibble_dot_cuda(packed, q)
        want = ref.nibble_dot_ref(packed, q)
        absdeq = deq_table.abs()[qz.unpack_4bit(packed).long()]
        tol = 1e-5 * (q.abs() @ absdeq.T) + 1e-6
        del absdeq
        err = (got - want).abs()
        ok = (got.shape == (b, n) and bool(torch.isfinite(got).all())
              and bool((err <= tol).all()))
        worst = float(err.max())
        parent = ""
        if parent_entries:
            same = same_as_parent(nibble_dot_cuda, packed, q)
            parent = f"; byte-equal to the parent's kernel: {same}"
            expect(same, f"scan kernel differs from the parent's at b={b} n={n} d'={d_pad}")
        say(f"scan   b={b:>3} n={n:>7} d'={d_pad:>5}: max|err|={worst:.3e} "
            f"(tol 1e-5*sum|q*deq|+1e-6) {'ok' if ok else 'MISMATCH'}{parent}")
        expect(ok, f"scan kernel disagrees at b={b} n={n} d'={d_pad}")
        return worst, packed, q, got

    scan_err = 0.0
    for b in (1, 7, 64):
        for n in (1, 300, N):
            worst, packed, q, got = check_scan(b, n, 1024)
            if (b, n) == (64, N):
                scan_err, main_packed, main_q, main_got = worst, packed, q, got
    check_scan(7, 300, 16)
    check_scan(64, BIG_N, 1024)
    # Determinism across batch composition: the first 7 queries alone give
    # the bytes they got inside the batch of 64.
    part = nibble_dot_cuda(main_packed, main_q[:7].contiguous())
    same = bool(torch.equal(part, main_got[:7]))
    say(f"scan rows independent of batch size (7 vs 64): {same}")
    expect(same, "scan scores depend on the batch")
    again = nibble_dot_cuda(main_packed, main_q)
    expect(bool(torch.equal(again, main_got)), "scan is not repeatable")
    del main_packed, main_q, main_got, part, again
    torch.cuda.empty_cache()

    # The binarized proxies are integers: each kernel must equal its plain
    # version bit for bit.
    proxy_fns = {"sign": (sign_hamming_cuda, ref.sign_hamming_ref, 8),
                 "crumb": (crumb_affinity_cuda, ref.crumb_affinity_ref, 4)}
    proxy_err = {}

    def check_proxy(kind: str, b: int, n: int, d_pad: int) -> None:
        fn, plain, dims_per_byte = proxy_fns[kind]
        width = d_pad // dims_per_byte
        codes = torch.from_numpy(rng.integers(0, 256, size=(n, width), dtype=np.uint8)).to(dev)
        qcodes = torch.from_numpy(rng.integers(0, 256, size=(b, width), dtype=np.uint8)).to(dev)
        got = fn(codes, qcodes)
        want = plain(codes, qcodes)
        ok = (got.dtype == torch.int32 and got.shape == (b, n)
              and bool(torch.equal(got, want)))
        proxy_err[kind] = max(proxy_err.get(kind, 0.0),
                              float((got.long() - want.long()).abs().max()))
        parent = ""
        if parent_entries:
            as_parent = same_as_parent(fn, codes, qcodes)
            parent = f"; bit-equal to the parent's kernel: {as_parent}"
            expect(as_parent, f"{kind} kernel differs from the parent's at b={b} n={n} "
                              f"d'={d_pad}")
        say(f"{kind:<6} b={b:>3} n={n:>7} d'={d_pad:>5}: "
            f"{'bit-equal' if ok else 'MISMATCH'}{parent}")
        expect(ok, f"{kind} kernel differs from its plain version at b={b} n={n} d'={d_pad}")

    for kind in proxy_fns:
        for b in (1, 7, 64):
            for n in (1, 300, N):
                check_proxy(kind, b, n, 1024)
        for d_pad in (8, 16, 136, 4096):
            check_proxy(kind, 7, 301, d_pad)
        check_proxy(kind, 65, 301, 1024)
        # Row tiles (128 crumb, 256 sign rows) that end ragged on either side.
        for n in (127, 129, 255, 257):
            check_proxy(kind, 64, n, 1024)
            check_proxy(kind, 65, n, 136)
        check_proxy(kind, 64, BIG_N, 1024)
    torch.cuda.empty_cache()
    # More queries than one launch takes (65,535 blocks of 64 on its grid's
    # y): the wrapper launches twice, and the result is its two halves'.
    for kind, (fn, plain, dims_per_byte) in proxy_fns.items():
        b_big, half = binary_dot.MAX_QUERIES + 1, binary_dot.MAX_QUERIES
        codes = torch.from_numpy(rng.integers(0, 256, size=(8, 8 // dims_per_byte),
                                              dtype=np.uint8)).to(dev)
        qcodes = torch.from_numpy(rng.integers(0, 256, size=(b_big, 8 // dims_per_byte),
                                               dtype=np.uint8)).to(dev)
        before = fn.launches
        whole = fn(codes, qcodes)
        launched = fn.launches - before
        halves = torch.cat([fn(codes, qcodes[:half]), fn(codes, qcodes[half:])])
        same = same_bytes(whole, halves)
        exact = bool(torch.equal(whole, plain(codes, qcodes)))
        say(f"{fn.__name__} at b={b_big} n=8 d'=8: {launched} launches, byte-equal to its "
            f"two halves: {same}, to its plain version: {exact}")
        expect(same and exact and launched == 2,
               f"{fn.__name__} at b={b_big} is not its two halves or its plain version")
        del codes, qcodes, whole, halves
    torch.cuda.empty_cache()

    # 2-bit codes and mixed [4-bit | 2-bit] rows.  The tolerance rule is the
    # 4-bit one, with each dim's |deq| from its own table.
    crumb_table = torch.tensor(lloydmax.CENTROIDS_2BIT, device=dev)

    def abs_deq(packed: torch.Tensor, bits: int, n4_dims: int = 0) -> torch.Tensor:
        """|deq| of every dim of packed rows [..., bytes] -> [..., d'] f32."""
        if bits == 4:
            return deq_table.abs()[qz.unpack_4bit(packed).long()]
        if bits == 2:
            return crumb_table.abs()[qz.unpack_2bit(packed).long()]
        b4 = n4_dims // 2
        return torch.cat([abs_deq(packed[..., :b4], 4), abs_deq(packed[..., b4:], 2)], dim=-1)

    def check_crumb_scan(b: int, n: int, d_pad: int) -> tuple:
        packed = torch.from_numpy(
            rng.integers(0, 256, size=(n, d_pad // 4), dtype=np.uint8)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, d_pad), dtype=np.float32)).to(dev)
        got = crumb_dot_cuda(packed, q)
        want = ref.crumb_dot_ref(packed, q)
        tol = 1e-5 * (q.abs() @ abs_deq(packed, 2).T) + 1e-6
        err = (got - want).abs()
        ok = (got.shape == (b, n) and bool(torch.isfinite(got).all())
              and bool((err <= tol).all()))
        worst = float(err.max())
        parent = ""
        if parent_entries:
            same = same_as_parent(crumb_dot_cuda, packed, q)
            parent = f"; byte-equal to the parent's kernel: {same}"
            expect(same, f"2-bit scan kernel differs from the parent's at b={b} n={n} "
                         f"d'={d_pad}")
        say(f"crumb scan b={b:>3} n={n:>7} d'={d_pad:>5}: max|err|={worst:.3e} "
            f"(tol 1e-5*sum|q*deq|+1e-6) {'ok' if ok else 'MISMATCH'}{parent}")
        expect(ok, f"2-bit scan kernel disagrees at b={b} n={n} d'={d_pad}")
        return worst, packed, q, got

    crumb_err = 0.0
    for b in (1, 7, 64):
        for n in (1, 300, N):
            worst, packed, q, got = check_crumb_scan(b, n, 1024)
            if (b, n) == (64, N):
                crumb_err, main_packed, main_q, main_got = worst, packed, q, got
    check_crumb_scan(7, 300, 16)
    check_crumb_scan(64, BIG_N, 1024)
    part = crumb_dot_cuda(main_packed, main_q[:7].contiguous())
    same = bool(torch.equal(part, main_got[:7]))
    say(f"2-bit scan rows independent of batch size (7 vs 64): {same}")
    expect(same, "2-bit scan scores depend on the batch")
    expect(bool(torch.equal(crumb_dot_cuda(main_packed, main_q), main_got)),
           "2-bit scan is not repeatable")
    del main_packed, main_q, main_got, part
    torch.cuda.empty_cache()

    def check_gather(bits: int, b: int, m: int, d_pad: int, n: int) -> float:
        """A gathered rescore against its plain version and, byte for byte,
        against the full scan of its width at the same (query, row)."""
        kernel, plain, scan, label = {
            4: (gather_nibble_dot_cuda, ref.gather_nibble_dot_ref, nibble_dot_cuda, "gather"),
            2: (gather_crumb_dot_cuda, ref.gather_crumb_dot_ref, crumb_dot_cuda,
                "gather crumb")}[bits]
        packed = torch.from_numpy(
            rng.integers(0, 256, size=(n, d_pad * bits // 8), dtype=np.uint8)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, d_pad), dtype=np.float32)).to(dev)
        cand = torch.from_numpy(rng.integers(0, n, size=(b, m)).astype(np.int32)).to(dev)
        cand[:, 3::7] = -1       # dead candidates and rows past the corpus score 0,
        cand[:, 5::11] = n       # and their rows are never read
        valid = (cand >= 0) & (cand < n)
        rows = cand.long().clamp(0, n - 1)
        got = kernel(packed, q, cand)
        want = plain(packed, q, cand)
        tol = 1e-5 * torch.einsum("bd,bmd->bm", q.abs(), abs_deq(packed[rows], bits)) + 1e-6
        err = (got - want).abs()
        ok = (got.shape == (b, m) and bool(torch.isfinite(got).all())
              and bool((err <= tol).all()))
        full = scan(packed, q).gather(1, rows)
        same = bool(torch.equal(got[valid], full[valid])) and bool((got[~valid] == 0).all())
        worst = float(err.max())
        say(f"{label} b={b:>3} m={m:>4} d'={d_pad:>5}: max|err|={worst:.3e} "
            f"(tol 1e-5*sum|q*deq|+1e-6) {'ok' if ok else 'MISMATCH'}; byte-equal to the "
            f"{bits}-bit scan at the same rows: {same}")
        expect(ok, f"gathered {bits}-bit kernel disagrees at b={b} m={m} d'={d_pad}")
        expect(same, f"gathered {bits}-bit kernel is not byte-equal to the {bits}-bit scan at "
                     f"b={b} m={m} d'={d_pad}")
        return worst

    gather_errs = {}
    for bits in (4, 2):
        for b in (1, 7, 64):
            for m in (1, 33, 80, 320, 1280):
                worst = check_gather(bits, b, m, 1024, N)
                if (b, m) == (64, 320):
                    gather_errs[bits] = worst
        for d_pad, n, shapes in ((16, 300, ((7, 80), (7, 33), (64, 320))),
                                 (4096, N, ((7, 33), (64, 320)))):
            for b, m in shapes:
                check_gather(bits, b, m, d_pad, n)
        torch.cuda.empty_cache()
    gather_err, gather_crumb_err = gather_errs[4], gather_errs[2]
    # More queries than one launch takes (its grid's 65,535): the wrapper
    # launches twice, and each score is the one its half gives alone.
    for bits, kernel in ((4, gather_nibble_dot_cuda), (2, gather_crumb_dot_cuda)):
        b_big, half = 65536, 32768
        packed = torch.from_numpy(
            rng.integers(0, 256, size=(300, 1024 * bits // 8), dtype=np.uint8)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b_big, 1024), dtype=np.float32)).to(dev)
        cand = torch.from_numpy(rng.integers(-1, 300, size=(b_big, 16)).astype(np.int32)).to(dev)
        before = kernel.launches
        whole = kernel(packed, q, cand)
        launched = kernel.launches - before
        halves = torch.cat([kernel(packed, q[:half], cand[:half]),
                            kernel(packed, q[half:], cand[half:])])
        same = same_bytes(whole, halves)
        say(f"{kernel.__name__} at b={b_big}: {launched} launches, byte-equal to its two "
            f"halves: {same}")
        expect(same and launched == 2, f"{kernel.__name__} at b={b_big} is not its two halves")
        del packed, q, cand, whole, halves
    torch.cuda.empty_cache()

    def check_mixed(n4: int, d_pad: int, n: int, b: int, m: int) -> None:
        """A mixed corpus through ops (two kernels on column views and an
        add), and each kernel on a view against its contiguous launch."""
        width = qz.bytes_per_vector(d_pad, 3, n4)
        packed = torch.from_numpy(rng.integers(0, 256, size=(n, width), dtype=np.uint8)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, d_pad), dtype=np.float32)).to(dev)
        cand = torch.from_numpy(rng.integers(0, n, size=(b, m)).astype(np.int32)).to(dev)
        cand[:, 3::7] = -1
        valid, rows = cand >= 0, cand.long().clamp(min=0)
        got = ops.score_raw(packed, q, bits=3, n4_dims=n4)
        tol = 1e-5 * (q.abs() @ abs_deq(packed, 3, n4).T) + 1e-6
        ok = bool(((got - ref.mixed_dot_ref(packed, q, n4)).abs() <= tol).all())
        g = ops.score_gathered_raw(packed, q, cand, bits=3, n4_dims=n4)
        g_ok = bool(((g - ref.gather_mixed_dot_ref(packed, q, cand, n4)).abs()
                     <= tol.gather(1, rows))[valid].all())
        same = bool(torch.equal(g[valid], got.gather(1, rows)[valid]))
        b4 = n4 // 2
        blocks = {4: (packed[:, :b4], q[:, :n4]), 2: (packed[:, b4:], q[:, n4:])}
        views = {}
        for name, fn, bits, gathered in (
                ("nibble_dot", nibble_dot_cuda, 4, False),
                ("crumb_dot", crumb_dot_cuda, 2, False),
                ("gather_nibble_dot", gather_nibble_dot_cuda, 4, True),
                ("gather_crumb_dot", gather_crumb_dot_cuda, 2, True)):
            pv, qv = blocks[bits]
            extra = (cand,) if gathered else ()
            views[name] = bool(torch.equal(fn(pv, qv, *extra),
                                           fn(pv.contiguous(), qv.contiguous(), *extra)))
        parent = ""
        if parent_entries:
            as_parent = {name: same_as_parent(fn, *blocks[bits])
                         for name, fn, bits in (("nibble_dot", nibble_dot_cuda, 4),
                                                ("crumb_dot", crumb_dot_cuda, 2))}
            parent = f"; scans on the views byte-equal to the parent's kernels: {as_parent}"
            expect(all(as_parent.values()), f"a scan kernel on a view differs from the "
                                            f"parent's at n4={n4} d'={d_pad}: {as_parent}")
        say(f"mixed n4={n4:>3} of d'={d_pad:>5} n={n:>6} b={b:>2} m={m:>3}: full scan within "
            f"tol {ok}; gathered within tol {g_ok} and byte-equal to the full scan {same}; "
            f"view == contiguous: {views}{parent}")
        expect(ok and g_ok, f"mixed scan disagrees at n4={n4} d'={d_pad}")
        expect(same, f"mixed gathered scan is not byte-equal to the full scan at n4={n4}")
        expect(all(views.values()), f"a kernel on a view differs from its contiguous launch "
                                    f"at n4={n4} d'={d_pad}: {views}")

    check_mixed(512, 1024, N, 64, 320)
    check_mixed(4, 16, 300, 7, 80)
    check_mixed(36, 64, 300, 7, 80)
    torch.cuda.empty_cache()
    report["kernel_checks"] = {"fwht_main_max_abs_err": fwht_err["main"],
                               "scan_main_max_abs_err": scan_err,
                               "proxy_max_abs_err": proxy_err,
                               "gather_main_max_abs_err": gather_err,
                               "crumb_scan_main_max_abs_err": crumb_err,
                               "gather_crumb_main_max_abs_err": gather_crumb_err}

    # ---- 4. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    corpus = embedding_corpus(SEED, N, DIM)
    queries = queries_from_corpus(corpus, SEED + 1, 64 * BATCHES)
    say(f"data: corpus {corpus.shape} queries {queries.shape} in "
        f"{time.perf_counter() - t0:.2f} s")

    # Every kernel's launch counter; each path runs between a reset and a read.
    counters = {"fwht": hadamard.fwht_cuda, "nibble_dot": nibble_dot_cuda,
                "sign_hamming": sign_hamming_cuda, "crumb_affinity": crumb_affinity_cuda,
                "gather_nibble_dot": gather_nibble_dot_cuda, "crumb_dot": crumb_dot_cuda,
                "gather_crumb_dot": gather_crumb_dot_cuda}

    def reset_counts() -> None:
        for counter in counters.values():
            counter.launches = 0

    def read_counts() -> dict:
        return {name: counter.launches for name, counter in counters.items()}

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = MonaVec.build(corpus, metric="cosine")
    torch.cuda.synchronize()
    main_build_s = time.perf_counter() - t0
    build_launches = read_counts()
    results = []
    t0 = time.perf_counter()
    for i in range(BATCHES):
        results.append(idx.search(queries[64 * i: 64 * (i + 1)], k=10))
    main_search_s = time.perf_counter() - t0
    launches = read_counts()
    search_launches = {k: launches[k] - build_launches[k] for k in launches}
    say(f"main path: build {N}x{DIM} in {main_build_s:.3f} s, "
        f"{BATCHES} searches of 64 in {main_search_s:.3f} s")
    say(f"launches: build {build_launches}, {BATCHES} searches {search_launches}")
    expect(launches["fwht"] > 0, "the Hadamard kernel was not launched on the main path")
    expect(launches["nibble_dot"] > 0, "the scan kernel was not launched on the main path")

    scores = np.concatenate([r[0] for r in results])
    ids = np.concatenate([r[1] for r in results])
    expect(scores.shape == (64 * BATCHES, 10) and np.isfinite(scores).all(),
           "search scores are not finite [b, 10]")
    expect(bool((ids < N).all()), "search returned a sentinel or out-of-range id")

    qt = torch.from_numpy(queries).to(dev)
    ct = torch.from_numpy(corpus).to(dev)
    exact = scoring.topk(scoring.score_f32(qt, ct, "cosine"), 10)[1].cpu().numpy()
    del ct

    def recall_of(found: np.ndarray) -> float:
        return float(np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(found, exact)]))

    recall = recall_of(ids)
    say(f"recall@10 vs exact f32 cosine ({64 * BATCHES} queries): {recall:.4f}")
    # The same index and queries through the port's plain versions on the CPU.
    cpu_scores, cpu_ids = MonaVec.build(corpus, metric="cosine", device="cpu").search(
        queries, k=10)
    recall_cpu = recall_of(cpu_ids)
    same_ids = float(np.mean(cpu_ids == ids))
    score_err = float(np.max(np.abs(cpu_scores - scores)))
    say(f"CPU plain path: recall@10 {recall_cpu:.4f}, ids equal in {same_ids:.4%} of "
        f"slots, max|score diff| {score_err:.3e}")
    expect(abs(recall - recall_cpu) <= 0.01, "recall differs from the CPU plain path")
    expect(same_ids >= 0.99, "ids differ from the CPU plain path in over 1% of slots")

    s2, i2 = idx.search(queries[:64], k=10)
    same = s2.tobytes() == results[0][0].tobytes() and i2.tobytes() == results[0][1].tobytes()
    say(f"repeat search byte-identical: {same}")
    expect(same, "a repeated search gave other bytes")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
        path = str(Path(td) / "smoke.mvec")
        idx.save(path)
        s3, i3 = MonaVec.load(path).search(queries[:64], k=10)
    same = np.array_equal(s3, results[0][0]) and np.array_equal(i3, results[0][1])
    say(f"save -> load -> search equal: {same}")
    expect(same, "save -> load -> search differs")

    # Codes from the kernel path vs the plain rotation on the card and on the CPU.
    enc = idx.backend.enc
    codes_kernel = qz.unpack_4bit(enc.packed)
    x = standardize.prepare(torch.from_numpy(corpus).to(dev), "cosine")
    codes_plain = lloydmax.quantize(hadamard.signed_fwht_plain(
        x, rhdh.rademacher_signs(enc.seed, enc.dim_pad, dev), enc.dim_pad))
    del x
    codes_cpu = qz.unpack_4bit(
        qz.encode(torch.from_numpy(corpus), metric="cosine", seed=enc.seed).packed).to(dev)
    n_codes = codes_kernel.numel()
    flips = {}
    for name, a, b in (("kernel_vs_plain_card", codes_kernel, codes_plain),
                       ("kernel_vs_cpu", codes_kernel, codes_cpu),
                       ("plain_card_vs_cpu", codes_plain, codes_cpu)):
        delta = (a.int() - b.int()).abs()
        flips[name] = {"flips": int((delta > 0).sum()), "max_level_delta": int(delta.max()),
                       "codes": n_codes}
    say(f"encode code flips at {N}x{DIM}: {json.dumps(flips)}")
    kp = flips["kernel_vs_plain_card"]
    expect(kp["flips"] <= 1e-4 * n_codes and kp["max_level_delta"] <= 1,
           "the Hadamard kernel flips more than 1e-4 of codes or by more than one level")
    report["main_path"] = {"build_s": main_build_s, "search_s": main_search_s,
                           "build_launches": build_launches,
                           "search_launches": search_launches, "recall_at_10": recall,
                           "recall_at_10_cpu": recall_cpu, "ids_equal_cpu": same_ids,
                           "max_score_diff_cpu": score_err, "flips": flips}
    del codes_kernel, codes_plain, codes_cpu

    # ---- 4b. the cascade path -------------------------------------------------
    proxy_counter = {"sign": "sign_hamming", "crumb": "crumb_affinity"}
    cascade_launches = dict.fromkeys(counters, 0)
    # The full scan's scores of every row, per batch as the searches run.
    full_scores = torch.cat([idx.backend.scores(qt[64 * i: 64 * (i + 1)])
                             for i in range(BATCHES)])
    cpu_base = MonaVec.from_arrays(enc.packed.cpu().numpy(), enc.qnorms.cpu().numpy(),
                                   seed=enc.seed, metric=enc.metric, bits=enc.bits,
                                   dim=enc.dim, dim_pad=enc.dim_pad, device="cpu")
    cascades = {}
    report["cascade"] = {}
    for kind in ("sign", "crumb"):
        cidx = MonaVec(idx.backend).enable_coarse(kind)
        cascades[kind] = cidx
        cpu_idx = MonaVec(cpu_base.backend).enable_coarse(kind)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
            path = str(Path(td) / f"cascade-{kind}.mvec")
            cidx.save(path)
            loaded = MonaVec.load(path)
        for rm in RESCORE_MULTS:
            label = f"cascade {kind} rescore_mult={rm}"
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [cidx.search(queries[64 * i: 64 * (i + 1)], k=10, rescore_mult=rm)
                   for i in range(BATCHES)]
            run_s = time.perf_counter() - t0
            got = read_counts()
            for name in counters:
                cascade_launches[name] += got[name]
            say(f"{label}: {BATCHES} searches of 64 in {run_s:.3f} s; launches {got}")
            expect(got[proxy_counter[kind]] > 0, f"{label}: the {kind} kernel was not launched")
            expect(got["gather_nibble_dot"] > 0, f"{label}: the gather kernel was not launched")
            expect(got["nibble_dot"] == 0, f"{label}: the full-scan kernel ran in the cascade")

            c_scores = np.concatenate([r[0] for r in res])
            c_ids = np.concatenate([r[1] for r in res])
            expect(c_scores.shape == (64 * BATCHES, 10) and np.isfinite(c_scores).all()
                   and bool((c_ids < N).all()), f"{label}: scores or ids out of contract")
            c_recall = recall_of(c_ids)
            vs_full = float(np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(c_ids, ids)]))
            cpu_s, cpu_i = cpu_idx.search(queries, k=10, rescore_mult=rm)
            c_recall_cpu = recall_of(cpu_i)
            c_same = float(np.mean(cpu_i == c_ids))
            rows = torch.from_numpy(c_ids.astype(np.int64)).to(dev)
            scan_scores = full_scores.gather(1, rows).cpu().numpy()
            scores_equal = scan_scores.tobytes() == c_scores.tobytes()
            s2, i2 = cidx.search(queries[:64], k=10, rescore_mult=rm)
            repeat = s2.tobytes() == res[0][0].tobytes() and i2.tobytes() == res[0][1].tobytes()
            s3, i3 = loaded.search(queries[:64], k=10, rescore_mult=rm)
            reload = np.array_equal(s3, res[0][0]) and np.array_equal(i3, res[0][1])
            say(f"{label}: recall@10 {c_recall:.4f} vs exact, {vs_full:.4f} vs the full "
                f"scan's ids; CPU plain cascade recall@10 {c_recall_cpu:.4f}, ids equal in "
                f"{c_same:.4%} of slots, max|score diff| "
                f"{float(np.max(np.abs(cpu_s - c_scores))):.3e}; scores byte-equal to the "
                f"full scan's: {scores_equal}; repeat byte-identical: {repeat}; "
                f"v10 save -> load -> search equal: {reload}")
            expect(abs(c_recall - c_recall_cpu) <= 0.01,
                   f"{label}: recall differs from the CPU plain cascade")
            expect(c_same >= 0.99, f"{label}: ids differ from the CPU plain cascade in over "
                                   f"1% of slots")
            expect(scores_equal, f"{label}: a returned score differs from the full scan's")
            expect(repeat, f"{label}: a repeated search gave other bytes")
            expect(reload, f"{label}: v10 save -> load -> search differs")
            report["cascade"][f"{kind}_{rm}"] = {
                "launches": got, "search_s": run_s, "recall_at_10": c_recall,
                "recall_vs_full_scan": vs_full, "recall_at_10_cpu": c_recall_cpu,
                "ids_equal_cpu": c_same, "scores_equal_full_scan": scores_equal}
        del loaded, cpu_idx
    del full_scores, cpu_base
    torch.cuda.empty_cache()

    # ---- 4c. 2-bit and mixed precision -----------------------------------------
    def build_precision(name: str, device) -> MonaVec:
        """bits=2, mixed on the leading dims, or mixed under the variance
        permutation of the first PERM_SAMPLE rotated rows (a v7 index, built
        as benchmarks/paper_tables.py builds Fig. 3's), all at the default seed."""
        if name == "bits2":
            return MonaVec.build(corpus, bits=2, device=device)
        if name == "mixed":
            return MonaVec.build(corpus, avg_bits=3.0, device=device)
        x = torch.from_numpy(corpus).to(device)
        sample = rhdh.rhdh_apply(standardize.prepare(x[:PERM_SAMPLE], "cosine"), enc.seed,
                                 normalized=False)
        penc = qz.encode_mixed(x, avg_bits=3.0, perm=qz.variance_permutation(sample))
        return MonaVec(BruteForceIndex(enc=penc, ids=np.arange(N, dtype=np.uint64)))

    def unpacked_codes(e: qz.Encoded) -> torch.Tensor:
        """Per-dim codes of any bit mode, in the packed dim order."""
        if e.bits == 4:
            return qz.unpack_4bit(e.packed)
        if e.bits == 2:
            return qz.unpack_2bit(e.packed)
        b4 = e.n4_dims // 2
        return torch.cat([qz.unpack_4bit(e.packed[:, :b4]), qz.unpack_2bit(e.packed[:, b4:])],
                         dim=1)

    precision_idx, precision_cascade = {}, {}
    precision_launches = dict.fromkeys(counters, 0)
    report["precision"] = {}
    t_phase = time.perf_counter()
    for name in PRECISIONS:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pidx = build_precision(name, dev)
        torch.cuda.synchronize()
        p_build_s = time.perf_counter() - t0
        p_build_l = read_counts()
        t0 = time.perf_counter()
        res = [pidx.search(queries[64 * i: 64 * (i + 1)], k=10) for i in range(BATCHES)]
        p_search_s = time.perf_counter() - t0
        got = read_counts()
        p_search_l = {k: got[k] - p_build_l[k] for k in got}
        for k in counters:
            precision_launches[k] += got[k]
        penc = pidx.backend.enc
        say(f"{name}: bits={penc.bits} n4_dims={penc.n4_dims} perm={penc.perm is not None} "
            f"{penc.bytes_per_vector()} B/row; build in {p_build_s:.3f} s, {BATCHES} searches "
            f"of 64 in {p_search_s:.3f} s; launches: build {p_build_l}, searches {p_search_l}")
        expect(p_search_l["fwht"] > 0 and p_search_l["crumb_dot"] > 0,
               f"{name}: the Hadamard or 2-bit scan kernel was not launched")
        expect((p_search_l["nibble_dot"] > 0) == (name != "bits2"),
               f"{name}: the 4-bit scan kernel ran {p_search_l['nibble_dot']} times")
        p_scores = np.concatenate([r[0] for r in res])
        p_ids = np.concatenate([r[1] for r in res])
        expect(p_scores.shape == (64 * BATCHES, 10) and np.isfinite(p_scores).all()
               and bool((p_ids < N).all()), f"{name}: scores or ids out of contract")
        p_recall = recall_of(p_ids)
        cpu_p = build_precision(name, "cpu")
        cpu_s, cpu_i = cpu_p.search(queries, k=10)
        cpu_s2, cpu_i2 = cpu_p.search(queries, k=10)
        cpu_repeat = cpu_s.tobytes() == cpu_s2.tobytes() and cpu_i.tobytes() == cpu_i2.tobytes()
        p_recall_cpu = recall_of(cpu_i)
        p_same = float(np.mean(cpu_i == p_ids))
        say(f"{name}: recall@10 {p_recall:.4f} vs exact f32 cosine; CPU plain path recall@10 "
            f"{p_recall_cpu:.4f}, ids equal in {p_same:.4%} of slots, max|score diff| "
            f"{float(np.max(np.abs(cpu_s - p_scores))):.3e}; CPU plain search repeated "
            f"byte-identical: {cpu_repeat}")
        expect(abs(p_recall - p_recall_cpu) <= 0.01, f"{name}: recall differs from the CPU")
        expect(p_same >= 0.99, f"{name}: ids differ from the CPU plain path in over 1% of slots")
        s2, i2 = pidx.search(queries[:64], k=10)
        repeat = s2.tobytes() == res[0][0].tobytes() and i2.tobytes() == res[0][1].tobytes()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
            path = str(Path(td) / f"{name}.mvec")
            pidx.save(path)
            version = Path(path).read_bytes()[4]
            s3, i3 = MonaVec.load(path).search(queries[:64], k=10)
        reload = s3.tobytes() == res[0][0].tobytes() and i3.tobytes() == res[0][1].tobytes()
        say(f"{name}: repeat byte-identical {repeat}; v{version} save -> load -> search "
            f"byte-identical {reload}")
        expect(repeat and reload, f"{name}: a repeat or a file round trip gave other bytes")
        expect(version == (7 if name == "v7" else 6), f"{name}: saved as version {version}")
        cenc = cpu_p.backend.enc
        perm_equal = (penc.perm is None and cenc.perm is None) or (
            penc.perm is not None and cenc.perm is not None
            and np.array_equal(penc.perm, cenc.perm))
        flips = {"codes": penc.n * penc.dim_pad, "perm_equal_cpu": perm_equal}
        if perm_equal:
            delta = (unpacked_codes(penc).int() - unpacked_codes(cenc).to(dev).int()).abs()
            flips.update(flips=int((delta > 0).sum()), max_level_delta=int(delta.max()))
            del delta
        say(f"{name}: card encode vs CPU encode: {json.dumps(flips)}")
        expect(perm_equal, f"{name}: the card's permutation differs from the CPU's")
        expect(flips.get("max_level_delta", 0) <= 1, f"{name}: a code moved by more than one level")

        # One cascade each: crumb on the 2-bit and v7 indexes, sign on mixed.
        kind = "sign" if name == "mixed" else "crumb"
        rm = max(RESCORE_MULTS)
        label = f"{name} cascade {kind} rescore_mult={rm}"
        cidx = MonaVec(pidx.backend).enable_coarse(kind)
        precision_idx[name], precision_cascade[name] = pidx, (cidx, kind)
        p_full = torch.cat([pidx.backend.scores(qt[64 * i: 64 * (i + 1)])
                            for i in range(BATCHES)])
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cres = [cidx.search(queries[64 * i: 64 * (i + 1)], k=10, rescore_mult=rm)
                for i in range(BATCHES)]
        c_run_s = time.perf_counter() - t0
        got = read_counts()
        for k in counters:
            precision_launches[k] += got[k]
        say(f"{label}: {BATCHES} searches of 64 in {c_run_s:.3f} s; launches {got}")
        expect(got[proxy_counter[kind]] > 0 and got["gather_crumb_dot"] > 0,
               f"{label}: the proxy or the gathered 2-bit kernel was not launched")
        expect((got["gather_nibble_dot"] > 0) == (name != "bits2"),
               f"{label}: the gathered 4-bit kernel ran {got['gather_nibble_dot']} times")
        expect(got["nibble_dot"] == 0 and got["crumb_dot"] == 0,
               f"{label}: a full-scan kernel ran in the cascade")
        c_scores = np.concatenate([r[0] for r in cres])
        c_ids = np.concatenate([r[1] for r in cres])
        expect(c_scores.shape == (64 * BATCHES, 10) and np.isfinite(c_scores).all()
               and bool((c_ids < N).all()), f"{label}: scores or ids out of contract")
        scores_equal = (p_full.gather(1, torch.from_numpy(c_ids.astype(np.int64)).to(dev))
                        .cpu().numpy().tobytes() == c_scores.tobytes())
        c_recall = recall_of(c_ids)
        vs_full = float(np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(c_ids, p_ids)]))
        s2, i2 = cidx.search(queries[:64], k=10, rescore_mult=rm)
        repeat = s2.tobytes() == cres[0][0].tobytes() and i2.tobytes() == cres[0][1].tobytes()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
            path = str(Path(td) / f"{name}-{kind}.mvec")
            cidx.save(path)
            s3, i3 = MonaVec.load(path).search(queries[:64], k=10, rescore_mult=rm)
        reload = s3.tobytes() == cres[0][0].tobytes() and i3.tobytes() == cres[0][1].tobytes()
        line = (f"{label}: recall@10 {c_recall:.4f} vs exact, {vs_full:.4f} vs the full "
                f"scan's ids; scores byte-equal to the full scan's: {scores_equal}; repeat "
                f"byte-identical: {repeat}; v10 save -> load -> search equal: {reload}")
        entry = {"launches": got, "search_s": c_run_s, "recall_at_10": c_recall,
                 "recall_vs_full_scan": vs_full, "scores_equal_full_scan": scores_equal}
        if kind == "crumb":
            nq = 64 * CPU_CASCADE_BATCHES
            cpu_c = MonaVec(cpu_p.backend).enable_coarse(kind)
            cpu_cs, cpu_ci = cpu_c.search(queries[:nq], k=10, rescore_mult=rm)
            cc_same = float(np.mean(cpu_ci == c_ids[:nq]))
            # recall_of zips with the exact ids: over the first nq queries here.
            cc_recall, card_recall = recall_of(cpu_ci), recall_of(c_ids[:nq])
            line += (f"; over the first {nq} queries the CPU plain cascade's ids are equal in "
                     f"{cc_same:.4%} of slots, recall@10 {cc_recall:.4f} (card "
                     f"{card_recall:.4f})")
            expect(cc_same >= 0.99, f"{label}: ids differ from the CPU plain cascade in over "
                                    f"1% of slots")
            expect(abs(cc_recall - card_recall) <= 0.01,
                   f"{label}: recall differs from the CPU plain cascade")
            entry.update(ids_equal_cpu=cc_same, recall_at_10_cpu=cc_recall, cpu_queries=nq)
            del cpu_c
        say(line)
        expect(scores_equal, f"{label}: a returned score differs from the full scan's")
        expect(repeat and reload, f"{label}: a repeat or a v10 round trip gave other bytes")
        report["precision"][name] = {
            "bits": penc.bits, "n4_dims": penc.n4_dims, "bytes_per_row": penc.bytes_per_vector(),
            "build_s": p_build_s, "search_s": p_search_s, "build_launches": p_build_l,
            "search_launches": p_search_l, "recall_at_10": p_recall,
            "recall_at_10_cpu": p_recall_cpu, "ids_equal_cpu": p_same,
            "cpu_repeat_identical": cpu_repeat, "flips": flips,
            f"cascade_{kind}_{rm}": entry}
        del cpu_p, p_full
        torch.cuda.empty_cache()
    say(f"phase 4c: {time.perf_counter() - t_phase:.1f} s")

    # ---- 4d. the paper's Fig. 3 ------------------------------------------------------
    # benchmarks/paper_tables.py::fig3_mixed_precision: an anisotropic
    # Gaussian (spectrum exp(-i/80)), 4,000 x 1024, 64 queries, seed 2.
    f_rng = np.random.RandomState(19)
    spectrum = np.exp(-np.arange(DIM) / 80).astype(np.float32)
    f_corpus = (f_rng.randn(4000, DIM) * spectrum).astype(np.float32)
    f_queries = (f_rng.randn(64, DIM) * spectrum).astype(np.float32)
    f_exact = scoring.topk(scoring.score_f32(torch.from_numpy(f_queries).to(dev),
                                             torch.from_numpy(f_corpus).to(dev), "cosine"),
                           10)[1].cpu().numpy()
    f_x = torch.from_numpy(f_corpus).to(dev)
    f_perm = qz.variance_permutation(rhdh.rhdh_apply(
        standardize.prepare(f_x[:PERM_SAMPLE], "cosine"), 2, normalized=False))
    fig3 = {"pure4bit": MonaVec.build(f_corpus, bits=4, seed=2),
            "mixed3bit_leading": MonaVec.build(f_corpus, avg_bits=3.0, seed=2),
            "mixed3bit_perm_v7": MonaVec(BruteForceIndex(
                enc=qz.encode_mixed(f_x, seed=2, avg_bits=3.0, perm=f_perm),
                ids=np.arange(4000, dtype=np.uint64))),
            "pure2bit": MonaVec.build(f_corpus, bits=2, seed=2)}
    report["fig3"] = {}
    for name, fidx in fig3.items():
        f_ids = fidx.search(f_queries, k=10)[1]
        f_recall = float(np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(f_ids, f_exact)]))
        comp = f_corpus.nbytes / fidx.backend.enc.packed.numel()
        say(f"fig3/{name}: recall@10 {f_recall:.3f}, compression {comp:.1f}x")
        expect(0.0 <= f_recall <= 1.0, f"fig3/{name}: recall out of range")
        report["fig3"][name] = {"recall_at_10": f_recall, "compression": comp}
    del fig3, f_x

    # ---- 4e. a corpus wider than one block's butterfly -------------------------
    # d' = 65536 takes the two-pass butterfly: build and search on the card
    # against the port's plain path on the CPU over the same corpus.
    w_corpus = embedding_corpus(SEED + 3, WIDE_N, WIDE_DIM)
    w_queries = queries_from_corpus(w_corpus, SEED + 4, 64)
    reset_counts()
    w_idx = MonaVec.build(w_corpus, metric="cosine")
    w_scores, w_ids = w_idx.search(w_queries, k=10)
    w_launches = read_counts()
    w_cpu = MonaVec.build(w_corpus, metric="cosine", device="cpu")
    cw_scores, cw_ids = w_cpu.search(w_queries, k=10)
    w_enc = w_idx.backend.enc
    delta = (qz.unpack_4bit(w_enc.packed).int()
             - qz.unpack_4bit(w_cpu.backend.enc.packed).to(dev).int()).abs()
    w_flips = {"flips": int((delta > 0).sum()), "max_level_delta": int(delta.max()),
               "codes": delta.numel()}
    w_same = float(np.mean(cw_ids == w_ids))
    say(f"wide: {WIDE_N}x{WIDE_DIM} (d'={w_enc.dim_pad}) launches {w_launches}; card encode "
        f"vs CPU encode {json.dumps(w_flips)}; search ids equal to the CPU plain path in "
        f"{w_same:.4%} of slots, max|score diff| "
        f"{float(np.max(np.abs(cw_scores - w_scores))):.3e}")
    expect(w_enc.dim_pad == 65536 and w_launches["fwht"] >= 2 and w_launches["nibble_dot"] > 0,
           "wide: the card path did not run the butterfly and the scan at d'=65536")
    expect(w_scores.shape == (64, 10) and np.isfinite(w_scores).all()
           and bool((w_ids < WIDE_N).all()), "wide: scores or ids out of contract")
    expect(w_flips["flips"] <= 1e-4 * w_flips["codes"] and w_flips["max_level_delta"] <= 1,
           "wide: the card encode flips more than 1e-4 of codes or by more than one level")
    expect(w_same >= 0.99, "wide: ids differ from the CPU plain path in over 1% of slots")
    report["wide"] = {"rows": WIDE_N, "dim": WIDE_DIM, "dim_pad": w_enc.dim_pad,
                      "launches": w_launches, "flips": w_flips, "ids_equal_cpu": w_same}
    del w_corpus, w_cpu, delta     # w_idx stays for phase 6's bucketing checks
    torch.cuda.empty_cache()

    # ---- 5. timing -----------------------------------------------------------
    # The 23 MB corpus stays in the 50 MB L2 between launches, as it does
    # between the searches of a server; the [45000, 1024] rotation does not.
    # A sample is `reps` launches between two CUDA events, after the last
    # sample has finished, divided by `reps`.  The kernels line's ms, plain_ms
    # and library_ms take one launch per sample, so a short kernel is charged
    # its wrapper's host dispatch too.  Each kernel is also timed with B2B
    # back-to-back launches per sample, where the host queues the next launch
    # while the card runs this one ("b2b" below).
    B2B = 10

    def time_ms(fn, iters: int = 50, warmup: int = 5, reps: int = 1) -> dict:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        times.sort()
        # The highest percentile with at least ten samples beyond it.
        p = 1.0 - 10.0 / iters
        return {"median": times[iters // 2], "p": p, "p_ms": times[int(p * iters) - 1],
                "samples": iters, "launches_per_sample": reps}

    def device_ms(fn, calls: int = B2B, samples: int = 5) -> float:
        """Device time per call: CUDA events around ``calls`` back-to-back
        calls queued behind a spin kernel, so the card runs them without
        waiting for the host; the median of ``samples``.  The spin is
        doubled until the host has queued every call before it ends (the
        events' first gap proves it)."""
        fn()
        torch.cuda.synchronize()
        spin = int(1e-3 * SM_CLOCK_HZ)
        times = []
        while len(times) < samples:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            torch.cuda._sleep(spin)
            marks[1].record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            queued_ms = 1e3 * (time.perf_counter() - t0)
            marks[2].record()
            marks[2].synchronize()
            if queued_ms >= marks[0].elapsed_time(marks[1]):
                spin *= 2      # the card caught up with the host: not a device time
                continue
            times.append(marks[1].elapsed_time(marks[2]) / calls)
        times.sort()
        return times[samples // 2]

    def three_ways(fn) -> tuple:
        """One launch a sample, back-to-back, and device time."""
        return time_ms(fn), time_ms(fn, reps=B2B), device_ms(fn)

    def parent_turns(run) -> tuple:
        """With --parent-csrc: ``run`` through the parent's kernels, this
        commit's, and the parent's again, each timed three ways (the caller
        timed this commit's first), and whether the two give the same bytes.
        Returns the report entries and a line of text."""
        new_out = run()
        with parent_kernels():
            same = bool(torch.equal(run(), new_out))
            p1 = three_ways(run)
        again = three_ways(run)
        with parent_kernels():
            p2 = three_ways(run)
        entries = {"parent": {"kernel": [p1[0], p2[0]], "b2b": [p1[1], p2[1]],
                              "device_ms": [p1[2], p2[2]], "equal_bytes": same},
                   "again": {"kernel": again[0], "b2b": again[1], "device_ms": again[2]}}
        text = (f"; in turns parent / this / parent: one launch {p1[0]['median']:.4f} / "
                f"{again[0]['median']:.4f} / {p2[0]['median']:.4f} ms, back-to-back "
                f"{p1[1]['median']:.4f} / {again[1]['median']:.4f} / {p2[1]['median']:.4f} ms, "
                f"device {p1[2]:.4f} / {again[2]:.4f} / {p2[2]:.4f} ms; same bytes {same}")
        return entries, text, same

    def time_kernel(label: str, run, plain, library, nbytes: float, ops: float,
                    ops_per_s: float = PEAK_F32_OPS_PER_S, plain_iters: int = 20) -> dict:
        """A kernel and its one-call yardstick, each timed three ways, its
        plain version, its bound, and with --parent-csrc the parent's kernel
        in turns."""
        t, t_b2b, t_dev = three_ways(run)
        l, l_b2b, l_dev = three_ways(library)
        e = {"kernel": t, "b2b": t_b2b, "device_ms": t_dev,
             "plain": time_ms(plain, iters=plain_iters, warmup=1),
             "library": l, "library_b2b": l_b2b, "library_device_ms": l_dev}
        e["bound_ms"], e["bound_by"] = bound_ms(nbytes=nbytes, ops=ops, ops_per_s=ops_per_s)
        line = (f"{label}: one launch {t['median']:.4f} ms, back-to-back "
                f"{t_b2b['median']:.4f} ms, device {t_dev:.4f} ms ("
                f"{e['bound_ms'] / t_dev:.1%} of the bound); yardstick {l['median']:.4f} / "
                f"{l_b2b['median']:.4f} / {l_dev:.4f} ms; bound {e['bound_ms']:.4f} ms "
                f"({e['bound_by']})")
        if parent_entries:
            turns, text, same = parent_turns(run)
            e.update(turns)
            line += text
            expect(same, f"{label}: the parent's kernel gave other bytes")
        say(line)
        return e

    # The full scans at the main shape: the 4-bit scan on the phase-4 index,
    # its yardstick one f32 matmul of the dequantized rows, `q_rot @ deq.T`.
    d_pad = enc.dim_pad
    b = 64
    q_rot = qz.encode_query(torch.from_numpy(queries[:b]).to(dev), enc).contiguous()
    deq_f32 = qz.decode(enc)
    scan_timing = time_kernel(
        "time nibble_dot", lambda: nibble_dot_cuda(enc.packed, q_rot),
        lambda: ref.nibble_dot_ref(enc.packed, q_rot), lambda: torch.matmul(q_rot, deq_f32.T),
        nbytes=enc.n * d_pad / 2 + 4 * b * d_pad + 4 * b * enc.n, ops=2.0 * b * enc.n * d_pad)
    del deq_f32
    t_scan, t_scan_plain, t_scan_lib = (scan_timing["kernel"], scan_timing["plain"],
                                        scan_timing["library"])
    scan_bound, scan_by = scan_timing["bound_ms"], scan_timing["bound_by"]
    # How the tiles of 64 queries x 128 rows fill the card: the 4-bit scan's
    # device time at corpora of 2 and 3 tiles for each SM and at the main
    # shape between them (random codes, b=64).
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile_fill = {}
    for rows in (2 * sms * 128, N, 3 * sms * 128):
        codes = torch.from_numpy(
            rng.integers(0, 256, size=(rows, d_pad // 2), dtype=np.uint8)).to(dev)
        tile_fill[rows] = {"tiles": -(-rows // 128),
                           "device_ms": device_ms(lambda: nibble_dot_cuda(codes, q_rot))}
        del codes
    say("tile fill (4-bit scan, b=64): " + ", ".join(
        f"n={rows}: {e['tiles']} tiles on {sms} SMs, device {e['device_ms']:.4f} ms"
        for rows, e in tile_fill.items()))

    x = standardize.prepare(torch.from_numpy(corpus).to(dev), "cosine").contiguous()
    signs = rhdh.rademacher_signs(enc.seed, d_pad, dev)
    h_dense = torch.tensor(rhdh.hadamard_matrix(d_pad), device=dev)
    # The butterfly at the build's [45000, 1024] and at a search's [64, 1024];
    # yardstick one f32 matmul by the dense H of the signed, padded rows.
    fwht_timing = {}
    for key, rows in (("fwht", x), ("fwht_query", standardize.prepare(
            torch.from_numpy(queries[:b]).to(dev), "cosine").contiguous())):
        xs = (rhdh.pad_to_pow2(rows, d_pad) * signs).contiguous()
        fwht_timing[key] = time_kernel(
            f"time fwht_rows [{rows.shape[0]}, {d_pad}]",
            lambda: hadamard.fwht_cuda(rows, signs, d_pad),
            lambda: hadamard.signed_fwht_plain(rows, signs, d_pad),
            lambda: torch.matmul(xs, h_dense),
            nbytes=4.0 * rows.shape[0] * (rows.shape[1] + d_pad) + 4 * d_pad,
            ops=float(rows.shape[0]) * d_pad * math.log2(d_pad))
    # The two-pass form past one block's 32768 at the build's bytes:
    # [703, 65536].  Its bound counts x read once and the output written
    # once, as a single pass would; the two passes move the output twice more.
    wide = torch.from_numpy(
        rng.standard_normal((N * DIM // 65536, 65536), dtype=np.float32)).to(dev)
    wide_signs = rhdh.rademacher_signs(enc.seed, 65536, dev)
    two_pass = dict(zip(("kernel", "b2b", "device_ms"),
                        three_ways(lambda: hadamard.fwht_cuda(wide, wide_signs, 65536))))
    two_pass["bound_ms"], two_pass["bound_by"] = bound_ms(
        nbytes=8.0 * wide.numel() + 4 * 65536, ops=16.0 * wide.numel())
    t2_dev, t2_bound = two_pass["device_ms"], two_pass["bound_ms"]
    say(f"time fwht_rows [{wide.shape[0]}, 65536] (two passes): one launch "
        f"{two_pass['kernel']['median']:.4f} ms, back-to-back {two_pass['b2b']['median']:.4f} "
        f"ms, device {t2_dev:.4f} ms ({t2_bound / t2_dev:.1%} of the bound {t2_bound:.4f} ms, "
        f"{two_pass['bound_by']})")
    del wide
    t_fwht, t_fwht_plain, t_fwht_lib = (fwht_timing["fwht"][k]
                                        for k in ("kernel", "plain", "library"))
    fwht_bound, fwht_by = fwht_timing["fwht"]["bound_ms"], fwht_timing["fwht"]["bound_by"]
    del xs, h_dense, x

    # The cascade's kernels.  Yardsticks, timed only: the proxies as one f32
    # matmul of the +-1 sign planes (= d' - 2 hamming) or of the crumb level
    # planes {-3, -1, 1, 3} (= the affinity); the rescore as one bmm of the
    # pre-gathered f32 rows.  All are integers below 2^24, so f32 is exact.
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)

    def bit_plane(codes: torch.Tensor) -> torch.Tensor:
        """[rows, w] packed bits -> [rows, 8 w] f32 of 0/1, little-endian."""
        return ((codes[..., None] >> shifts) & 1).reshape(codes.shape[0], -1).float()

    def yardstick_planes(kind: str, codes: torch.Tensor) -> torch.Tensor:
        if kind == "sign":
            return 2 * bit_plane(codes) - 1
        half = codes.shape[1] // 2
        return 4 * bit_plane(codes[:, :half]) + 2 * bit_plane(codes[:, half:]) - 3

    def time_proxy(kind: str, codes: torch.Tensor, qcodes: torch.Tensor,
                   plain_iters: int) -> dict:
        fn, plain, _ = proxy_fns[kind]
        n_rows, d_p = codes.shape[0], d_pad
        run = lambda: fn(codes, qcodes)
        t, t_b2b, t_dev = three_ways(run)
        tp = time_ms(lambda: plain(codes, qcodes), iters=plain_iters, warmup=1)
        pc, pq = yardstick_planes(kind, codes), yardstick_planes(kind, qcodes)
        lib_out = torch.matmul(pq, pc.T)
        want = fn(codes, qcodes)
        same = bool(torch.equal(lib_out, (d_p - 2 * want if kind == "sign" else want).float()))
        expect(same, f"the {kind} yardstick does not compute the {kind} proxy")
        tl, tl_b2b, tl_dev = three_ways(lambda: torch.matmul(pq, pc.T))
        del pc, pq, lib_out
        b_q = qcodes.shape[0]
        # The bound: the codes, the query codes and the int32 output once,
        # against the proxy as the exact int8 product the yardstick above
        # computes (2 b n d' operations) at the int8 tensor-core rate.
        bnd, by = bound_ms(nbytes=codes.numel() + qcodes.numel() + 4.0 * b_q * n_rows,
                           ops=2.0 * b_q * n_rows * d_p, ops_per_s=PEAK_INT8_OPS_PER_S)
        e = {"kernel": t, "b2b": t_b2b, "device_ms": t_dev, "plain": tp, "library": tl,
             "library_b2b": tl_b2b, "library_device_ms": tl_dev, "bound_ms": bnd,
             "bound_by": by, "rows": n_rows}
        line = (f"time {fn.__name__} n={n_rows}: one launch {t['median']:.4f} ms, "
                f"back-to-back {t_b2b['median']:.4f} ms, device {t_dev:.4f} ms "
                f"({bnd / t_dev:.1%} of the bound {bnd:.4f} ms, {by}); yardstick "
                f"{tl['median']:.4f} / {tl_b2b['median']:.4f} / {tl_dev:.4f} ms")
        if parent_entries:
            turns, text, same = parent_turns(run)
            e.update(turns)
            line += text
            expect(same, f"{fn.__name__} n={n_rows}: the parent's kernel gave other bytes")
        say(line)
        return e

    timing_new = {"fwht_query": fwht_timing["fwht_query"]}
    qcodes_main = {"sign": binary.query_sign_bits(q_rot),
                   "crumb": binary.query_crumb_planes(q_rot)}
    for kind in ("sign", "crumb"):
        timing_new[kind] = time_proxy(kind, cascades[kind].backend.enc.ccodes,
                                      qcodes_main[kind], plain_iters=20)
        width = cascades[kind].backend.enc.ccodes.shape[1]
        big_codes = torch.from_numpy(
            rng.integers(0, 256, size=(BIG_N, width), dtype=np.uint8)).to(dev)
        timing_new[f"{kind}_1m"] = time_proxy(kind, big_codes, qcodes_main[kind],
                                              plain_iters=11)
        del big_codes
        torch.cuda.empty_cache()

    # The 2-bit kernels on the phase-4c 2-bit index; yardstick as for 4-bit:
    # `q_rot @ deq2.T`.
    enc2 = precision_idx["bits2"].backend.enc
    q_rot2 = qz.encode_query(torch.from_numpy(queries[:b]).to(dev), enc2).contiguous()
    deq2 = qz.decode(enc2)
    timing_new["crumb_scan"] = time_kernel(
        "time crumb_dot", lambda: crumb_dot_cuda(enc2.packed, q_rot2),
        lambda: ref.crumb_dot_ref(enc2.packed, q_rot2), lambda: torch.matmul(q_rot2, deq2.T),
        nbytes=enc2.n * d_pad / 4 + 4 * b * d_pad + 4 * b * enc2.n,
        ops=2.0 * b * enc2.n * d_pad)
    del deq2

    # The gathered rescores on the survivors the cascade picks at m = 10 *
    # rescore_mult: 4-bit on the phase-4 index after the sign proxy, 2-bit on
    # the 2-bit index after the crumb proxy.  Each kernel is timed one launch
    # a sample, back-to-back and as device time, and so is its
    # yardstick, one bmm of the pre-gathered f32 rows.  The chain floor is a
    # design figure: d' dependent FMAs at FMA_LATENCY_CYCLES each.
    chain_floor_ms = 1e3 * d_pad * FMA_LATENCY_CYCLES / SM_CLOCK_HZ
    rescore_inputs = {
        4: ("gather", gather_nibble_dot_cuda, ref.gather_nibble_dot_ref, qz.unpack_4bit,
            enc.packed, q_rot, binary.coarse_scan_stage(
                q_rot, cascades["sign"].backend.enc.ccodes, kind="sign"),
            torch.ones(enc.n, dtype=torch.bool, device=dev)),
        2: ("gather_crumb", gather_crumb_dot_cuda, ref.gather_crumb_dot_ref, qz.unpack_2bit,
            enc2.packed, q_rot2, binary.coarse_scan_stage(
                q_rot2, precision_cascade["bits2"][0].backend.enc.ccodes, kind="crumb"),
            None)}
    for bits, (key, kernel, plain, unpack, packed, qr, proxy, live) in rescore_inputs.items():
        for m in (10 * rm for rm in RESCORE_MULTS):
            cand = binary.survivor_topk_stage(proxy, live, m=m)
            rows_f32 = lloydmax.dequantize(unpack(packed[cand.long()]), bits)
            bmm = lambda: torch.bmm(rows_f32, qr[:, :, None])
            run = lambda: kernel(packed, qr, cand)
            bnd, by, n_rows = gathered_bound_ms(torch, cand, d_pad, bits)
            e = {"distinct_rows": n_rows, "kernel": time_ms(run), "b2b": time_ms(run, reps=B2B),
                 "device_ms": device_ms(run),
                 "plain": time_ms(lambda: plain(packed, qr, cand), iters=20),
                 "library": time_ms(bmm), "library_b2b": time_ms(bmm, reps=B2B),
                 "library_device_ms": device_ms(bmm), "bound_ms": bnd, "bound_by": by,
                 "chain_floor_ms": chain_floor_ms}
            line = (f"rescore {kernel.__name__} m={m} ({n_rows} distinct rows): one launch "
                    f"{e['kernel']['median']:.4f} "
                    f"ms, back-to-back {e['b2b']['median']:.4f} ms, device "
                    f"{e['device_ms']:.4f} ms; bmm yardstick {e['library']['median']:.4f} / "
                    f"{e['library_b2b']['median']:.4f} / {e['library_device_ms']:.4f} ms; "
                    f"bound {bnd:.4f} ms ({by}); chain floor {chain_floor_ms:.4f} ms (design "
                    f"figure: {d_pad} dependent FMAs x {FMA_LATENCY_CYCLES} cycles at "
                    f"{SM_CLOCK_HZ / 1e9:.2f} GHz)")
            if parent_entries:
                turns, text, same = parent_turns(run)
                e.update(turns)
                line += text
                expect(same, f"{kernel.__name__} m={m}: the parent's kernel gave other bytes")
            say(line)
            timing_new[f"{key}_{m}"] = e
            del rows_f32
    del rescore_inputs
    # One candidate alone, a single warp on the card: its device time at two
    # widths gives the chain's cost a dim, beside the 4-cycle FMA latency.
    lone_chain = {}
    for bits, kernel in ((4, gather_nibble_dot_cuda), (2, gather_crumb_dot_cuda)):
        lone = {}
        for width in (1024, 4096):
            codes = torch.from_numpy(
                rng.integers(0, 256, size=(1000, width * bits // 8), dtype=np.uint8)).to(dev)
            q1 = torch.from_numpy(rng.standard_normal((1, width), dtype=np.float32)).to(dev)
            one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            lone[width] = device_ms(lambda: kernel(codes, q1, one))
        cycles = (lone[4096] - lone[1024]) * 1e-3 / 3072 * SM_CLOCK_HZ
        lone_chain[bits] = {"device_ms": lone, "cycles_per_dim": cycles}
        say(f"rescore {kernel.__name__}, one candidate alone (b=1, m=1): device "
            f"{lone[1024]:.4f} ms at d'=1024, {lone[4096]:.4f} ms at d'=4096: {cycles:.2f} "
            f"cycles a dim at {SM_CLOCK_HZ / 1e9:.2f} GHz (the FMA chain alone: "
            f"{FMA_LATENCY_CYCLES})")
    # The mixed scan as the search runs it: two kernels on column views and
    # one add; its bound is the two blocks' (the codes are 384 B a row).
    encm = precision_idx["mixed"].backend.enc
    q_rotm = qz.encode_query(torch.from_numpy(queries[:b]).to(dev), encm).contiguous()
    deqm = qz.decode(encm)
    timing_new["mixed_scan"] = time_kernel(
        "time mixed scan (two kernels + add)",
        lambda: ops.score_raw(encm.packed, q_rotm, bits=3, n4_dims=encm.n4_dims),
        lambda: ref.mixed_dot_ref(encm.packed, q_rotm, encm.n4_dims),
        lambda: torch.matmul(q_rotm, deqm.T),
        nbytes=encm.n * encm.bytes_per_vector() + 4 * b * d_pad + 4 * b * encm.n,
        ops=2.0 * b * encm.n * d_pad)
    del deqm

    timing_old = {
        "scan": scan_timing,
        "fwht": fwht_timing["fwht"]}
    for name, e in {**timing_old, **timing_new}.items():
        t = e["kernel"]
        say(f"time {name}: kernel {t['median']:.4f} ms (p{round(100 * t['p'])} "
            f"{t['p_ms']:.4f}, {t['samples']} samples of one launch), back-to-back "
            f"{e['b2b']['median']:.4f} ms ({B2B} launches a sample), plain "
            f"{e['plain']['median']:.4f} ms, library {e['library']['median']:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})")

    # End to end: search rate over timed batches of 64, and the encode rate.
    full_lat = batch_latencies(lambda qb: idx.search(qb, k=10), queries, 100)
    builds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MonaVec.build(corpus, metric="cosine")
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    encode_s = sorted(builds)[2]
    say(f"search: {full_lat['qps']:.1f} queries/s over {full_lat['batches']} batches of 64; "
        f"batch latency median {full_lat['median_ms']:.3f} ms p90 {full_lat['p90_ms']:.3f} ms")
    say(f"encode: {N / encode_s:.1f} rows/s ({N}x{DIM} from host numpy, "
        f"median of 5 builds: {encode_s:.4f} s)")
    report["timing"] = {
        **timing_old,
        "search_qps": full_lat["qps"], "search_batch_ms_median": full_lat["median_ms"],
        "search_batch_ms_p90": full_lat["p90_ms"], "encode_rows_per_s": N / encode_s,
        **timing_new, "rescore_lone_candidate": lone_chain, "scan_tile_fill": tile_fill,
        "fwht_two_pass": two_pass,
    }
    # Searches replay CUDA graphs, which the profiler must not trace: its
    # breakdown is of the same plan's stages run eagerly (the same kernels,
    # phase 6 holds their bytes equal), and the graph's own device time is
    # taken by CUDA events (graph_device_ms).
    report["profile"] = {
        "search": profile_window(torch, lambda: [
            search_eager(idx, queries[64 * i: 64 * (i + 1)]) for i in range(BATCHES)],
            f"eager stages of {BATCHES} searches of 64"),
        "build": profile_window(torch, lambda: MonaVec.build(corpus, metric="cosine"),
                                f"one build of {N}x{DIM}"),
    }
    # An estimate, not a measurement: the device time per batch (a graph
    # replay's by events, or the traced eager stages') over the untraced
    # median batch latency.
    def idle_estimate(window: dict, latency: dict, label: str,
                      device_ms: Optional[float] = None) -> None:
        how = "graph replay device time (events)"
        if device_ms is None:
            device_ms, how = window["device_busy_us"] / BATCHES / 1e3, "traced device time"
        idle_est = max(0.0, 1.0 - device_ms / latency["median_ms"])
        window["idle_share_untraced_estimate"] = idle_est
        window["device_ms_per_batch"] = device_ms
        say(f"{label} idle share, estimated untraced: {idle_est:.3f} ({how} {device_ms:.4f} "
            f"ms per batch over the untraced median batch latency "
            f"{latency['median_ms']:.4f} ms)")

    idle_estimate(report["profile"]["search"], full_lat, "search",
                  graph_device_ms(torch, idx, {}, queries))

    # The cascade end to end, beside the full scan above.
    report["cascade_timing"] = {}
    for kind, cidx in cascades.items():
        for rm in RESCORE_MULTS:
            label = f"cascade {kind} rescore_mult={rm}"
            lat_c = batch_latencies(
                lambda qb: cidx.search(qb, k=10, rescore_mult=rm), queries, 100)
            say(f"{label}: {lat_c['qps']:.1f} queries/s over {lat_c['batches']} batches "
                f"of 64; batch latency median {lat_c['median_ms']:.3f} ms p90 "
                f"{lat_c['p90_ms']:.3f} ms ({lat_c['qps'] / full_lat['qps']:.2f}x the full "
                f"scan's rate)")
            window = profile_window(torch, lambda: [
                search_eager(cidx, queries[64 * i: 64 * (i + 1)], rescore_mult=rm)
                for i in range(BATCHES)], f"{label}, eager stages of {BATCHES} searches of 64",
                top=8)
            idle_estimate(window, lat_c, label,
                          graph_device_ms(torch, cidx, {"rescore_mult": rm}, queries))
            report["cascade_timing"][f"{kind}_{rm}"] = {"latency": lat_c, "profile": window}

    # 2-bit and mixed precision end to end: each full scan and its cascade,
    # each after the 4-bit full scan once more, since host-clocked rates
    # drift within a process.
    report["precision_timing"] = {}
    for name in PRECISIONS:
        pidx = precision_idx[name]
        cidx, kind = precision_cascade[name]
        rm = max(RESCORE_MULTS)
        lat4 = batch_latencies(lambda qb: idx.search(qb, k=10), queries, 100)
        say(f"4-bit full scan again, before {name}: {lat4['qps']:.1f} queries/s; batch "
            f"latency median {lat4['median_ms']:.3f} ms p90 {lat4['p90_ms']:.3f} ms")
        entry = {"full_4bit_before": lat4}
        for what, index, kw in (("full", pidx, {}), (f"{kind}_{rm}", cidx, {"rescore_mult": rm})):
            fn = lambda qb: index.search(qb, k=10, **kw)
            label = f"{name} {'full scan' if what == 'full' else 'cascade ' + what}"
            lat_p = batch_latencies(fn, queries, 100)
            say(f"{label}: {lat_p['qps']:.1f} queries/s over {lat_p['batches']} batches of 64; "
                f"batch latency median {lat_p['median_ms']:.3f} ms p90 {lat_p['p90_ms']:.3f} ms "
                f"({lat_p['qps'] / lat4['qps']:.2f}x the 4-bit full scan's rate just before)")
            window = profile_window(torch, lambda: [
                search_eager(index, queries[64 * i: 64 * (i + 1)], **kw)
                for i in range(BATCHES)], f"{label}, eager stages of {BATCHES} searches of 64",
                top=8)
            idle_estimate(window, lat_p, label, graph_device_ms(torch, index, kw, queries))
            entry[what] = {"latency": lat_p, "profile": window}
        report["precision_timing"][name] = entry

    # n=1,000,000 random codes: the full scan against each cascade, timing only.
    big_rng = np.random.default_rng(SEED + 2)
    big = MonaVec.from_arrays(
        big_rng.integers(0, 256, size=(BIG_N, DIM // 2), dtype=np.uint8),
        np.ones(BIG_N, np.float32), seed=SEED, metric="cosine", bits=4, dim=DIM,
        dim_pad=DIM)
    big_q = big_rng.standard_normal((64 * BATCHES, DIM), dtype=np.float32)
    big_lat = {"full": batch_latencies(lambda qb: big.search(qb, k=10), big_q, BIG_BATCHES)}
    big_cascades = {}
    for kind in ("sign", "crumb"):
        big_c = big_cascades[kind] = MonaVec(big.backend).enable_coarse(kind)
        for rm in RESCORE_MULTS:
            big_lat[f"{kind}_{rm}"] = batch_latencies(
                lambda qb: big_c.search(qb, k=10, rescore_mult=rm), big_q, BIG_BATCHES)
    big2 = MonaVec.from_arrays(
        big_rng.integers(0, 256, size=(BIG_N, DIM // 4), dtype=np.uint8),
        np.ones(BIG_N, np.float32), seed=SEED, metric="cosine", bits=2, dim=DIM,
        dim_pad=DIM)
    big_lat["full_2bit"] = batch_latencies(lambda qb: big2.search(qb, k=10), big_q, BIG_BATCHES)
    del big2
    for name, lat_b in big_lat.items():
        say(f"n={BIG_N} {name}: batch latency median {lat_b['median_ms']:.3f} ms p90 "
            f"{lat_b['p90_ms']:.3f} ms, {lat_b['qps']:.1f} queries/s over "
            f"{lat_b['batches']} batches of 64")
    report["big_n_latency"] = big_lat

    # ---- 6. the engine -------------------------------------------------------
    t_phase = time.perf_counter()
    paths = {"full": (idx, {})}
    for kind, cidx in cascades.items():
        for rm in RESCORE_MULTS:
            paths[f"{kind}_{rm}"] = (cidx, {"rescore_mult": rm})
    for name in PRECISIONS:
        cidx, kind = precision_cascade[name]
        paths[f"{name}_full"] = (precision_idx[name], {})
        paths[f"{name}_{kind}_{max(RESCORE_MULTS)}"] = (cidx, {"rescore_mult": max(RESCORE_MULTS)})

    report["engine"] = {"paths": {
        label: engine_checks(label, index, kw, queries) for label, (index, kw) in paths.items()}}
    # The phase-4e index: rows of 40,000 dims, whose norms a reduction
    # splits across blocks.
    report["engine"]["paths"]["wide_full"] = engine_checks("wide_full", w_idx, {}, w_queries)
    del w_idx

    # Warm-up, then nothing new: one capture, then every replay adds its
    # graph's tally to the launch counters and mints no plan or graph.
    cache = engine.plan_cache()
    for label in ("full", f"sign_{max(RESCORE_MULTS)}"):
        index, kw = paths[label]
        # A fresh handle on the same tensors holds no graph yet (the graphs
        # live with the backend); an empty cache holds no plan.
        fresh = MonaVec(dataclasses.replace(index.backend), index.mut)
        cache.clear()
        searcher = fresh.searcher(k=10, **kw)
        before = cache.stats.snapshot()
        searcher.warmup(64)
        warm = cache.stats.since(before)
        (graph,) = fresh.backend.graphs.values()
        tally = {name: graph.tally.get(counter, 0) for name, counter in counters.items()}
        reset_counts()
        before = cache.stats.snapshot()
        for i in range(BATCHES):
            searcher(queries[64 * i: 64 * (i + 1)])
        after = cache.stats.since(before)
        got = read_counts()
        per_replay = all(got[n] == BATCHES * tally[n] for n in counters)
        say(f"engine warm-up {label}: warmup(64) misses {warm.misses} captures "
            f"{warm.captures}; {BATCHES} searches after: misses {after.misses} captures "
            f"{after.captures} hits {after.hits}; tally per replay {tally}, launches {got}")
        expect(warm.misses == 1 and warm.captures == 1,
               f"engine {label}: warmup(64) did not capture exactly once")
        expect(after.misses == 0 and after.captures == 0 and after.hits == BATCHES,
               f"engine {label}: searches after the warm-up minted a plan or a graph")
        expect(per_replay and sum(tally.values()) > 0,
               f"engine {label}: launches did not grow by the graph's tally each replay")
        report["engine"][f"warmup_{label}"] = {"warmup": dataclasses.asdict(warm),
                                               "after": dataclasses.asdict(after),
                                               "tally": tally, "launches": got}
        del fresh, searcher, graph

    # Latency in turns, graph / eager / graph / eager, and the idle share of
    # each, at 45,000 and 1,000,000 rows.
    def in_turns(label, index, kw, qs, batches) -> dict:
        graph_fn = lambda qb: index.search(qb, k=10, **kw)
        eager_fn = lambda qb: search_eager(index, qb, **kw)
        runs = {"graph": [], "eager": []}
        for mode in ("graph", "eager", "graph", "eager"):
            runs[mode].append(batch_latencies(graph_fn if mode == "graph" else eager_fn,
                                              qs, batches))
        # The eager stages traced (the graph's kernels), and each mode's
        # idle share: the graph's by its replay's device time (events).
        window = profile_window(torch, lambda: [
            eager_fn(qs[64 * i: 64 * (i + 1)]) for i in range(BATCHES)],
            f"{label} eager, {BATCHES} searches of 64", top=6)
        entry = {"graph": {"profile": {}}, "eager": {"profile": window}}
        idle_estimate(entry["graph"]["profile"], runs["graph"][0], f"{label} graph",
                      graph_device_ms(torch, index, kw, qs))
        idle_estimate(window, runs["eager"][0], f"{label} eager")
        for mode in ("graph", "eager"):
            med = [r["median_ms"] for r in runs[mode]]
            entry[mode].update(latency=runs[mode], spread_ms=max(med) - min(med))
        # The engine's own spans over `batches` more graph searches: what
        # of a search's host-clocked time each step takes.
        obs.registry().reset()
        t0 = time.perf_counter()
        for i in range(batches):
            graph_fn(qs[64 * (i % BATCHES): 64 * (i % BATCHES + 1)])
        wall_us = 1e6 * (time.perf_counter() - t0) / batches
        hists = obs.registry().snapshot()["histograms"]
        spans = {stage: hists[key]["sum"] / hists[key]["count"]
                 for stage in ("plan_lookup", "execute", "sync")
                 for key in hists if key.startswith("engine.stage_us")
                 and f'stage="{stage}"' in key}
        spans["rest"] = wall_us - sum(spans.values())
        entry["graph"]["spans_us"] = spans
        say(f"spans {label} (graph, mean us a search of {wall_us:.1f}): " + ", ".join(
            f"{k} {v:.1f}" for k, v in spans.items()))
        g, e = entry["graph"]["latency"], entry["eager"]["latency"]
        say(f"turns {label}: batch median graph {g[0]['median_ms']:.4f} / "
            f"{g[1]['median_ms']:.4f} ms, eager {e[0]['median_ms']:.4f} / "
            f"{e[1]['median_ms']:.4f} ms (graph, eager, graph, eager); p90 graph "
            f"{g[0]['p90_ms']:.4f} / {g[1]['p90_ms']:.4f}, eager {e[0]['p90_ms']:.4f} / "
            f"{e[1]['p90_ms']:.4f} ms")
        return entry

    report["engine"]["turns"] = {
        label: in_turns(label, *paths[label], queries, 100)
        for label in ["full"] + [f"{k}_{rm}" for k in cascades for rm in RESCORE_MULTS]}
    big_paths = {"full": (big, {})}
    for kind, big_c in big_cascades.items():
        for rm in RESCORE_MULTS:
            big_paths[f"{kind}_{rm}"] = (big_c, {"rescore_mult": rm})
    report["engine"]["turns_1m"] = {
        label: in_turns(f"n={BIG_N} {label}", index, kw, big_q, BIG_BATCHES)
        for label, (index, kw) in big_paths.items()}
    report["engine"]["memory_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    say(f"engine: {len(cache)} plans cached; torch.cuda.memory_reserved() "
        f"{report['engine']['memory_reserved_gb']:.2f} GB after the captures")
    del big, big_cascades, big_paths
    torch.cuda.empty_cache()
    say(f"phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- 6b. the lifecycle ---------------------------------------------------
    t_phase = time.perf_counter()
    report["lifecycle"] = lifecycle_phase(torch, np, dev, corpus, queries, say, expect)
    torch.cuda.empty_cache()
    say(f"phase 6b: {time.perf_counter() - t_phase:.1f} s")

    # ---- 7. metadata, where= predicates, IVF ----------------------------------
    # The earlier phases' indexes go first, and their graphs with them.
    del idx, cascades, precision_idx, precision_cascade, paths
    cidx = pidx = index = big_c = loaded = None
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["filter_ivf"] = filter_ivf_phase(SimpleNamespace(
        torch=torch, np=np, dev=dev, corpus=corpus, queries=queries, expect=expect, say=say,
        reset_counts=reset_counts, read_counts=read_counts, time_ms=time_ms,
        device_ms=device_ms, B2B=B2B, gather_nibble_dot_cuda=gather_nibble_dot_cuda,
        gather_crumb_dot_cuda=gather_crumb_dot_cuda))
    torch.cuda.empty_cache()
    say(f"phase 7: {time.perf_counter() - t_phase:.1f} s")

    kernels = [
        {"name": "nibble_dot", "route": "cuda",
         "source": "src/repro_torch/csrc/nibble_dot.cu",
         "replaces": "src/repro/kernels/nibble_dot.py:62",
         "launches": launches["nibble_dot"], "max_abs_err": scan_err,
         "ms": t_scan["median"], "plain_ms": t_scan_plain["median"],
         "bound_ms": scan_bound, "bound_by": scan_by, "library_ms": t_scan_lib["median"]},
        {"name": "fwht", "route": "cuda",
         "source": "src/repro_torch/csrc/hadamard.cu",
         "replaces": "src/repro/kernels/hadamard.py:26",
         "launches": launches["fwht"], "max_abs_err": fwht_err["main"],
         "ms": t_fwht["median"], "plain_ms": t_fwht_plain["median"],
         "bound_ms": fwht_bound, "bound_by": fwht_by, "library_ms": t_fwht_lib["median"]},
    ]
    new_kernels = (("sign_hamming", "binary_dot", "binary_dot.py:93", "sign",
                    proxy_err["sign"]),
                   ("crumb_affinity", "binary_dot", "binary_dot.py:196", "crumb",
                    proxy_err["crumb"]),
                   ("gather_nibble_dot", "gather_dot", "gather_dot.py:89",
                    f"gather_{10 * max(RESCORE_MULTS)}", gather_err))
    path_launches = {name: cascade_launches[name] for name, *_ in new_kernels}
    # The 2-bit kernels run on the phase-4c paths.
    new_kernels += (("crumb_dot", "nibble_dot", "nibble_dot.py:130", "crumb_scan", crumb_err),
                    ("gather_crumb_dot", "gather_dot", "gather_dot.py:103",
                     f"gather_crumb_{10 * max(RESCORE_MULTS)}", gather_crumb_err))
    path_launches.update(crumb_dot=precision_launches["crumb_dot"],
                         gather_crumb_dot=precision_launches["gather_crumb_dot"])
    for name, source, replaces, key, err in new_kernels:
        entry = timing_new[key]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{replaces}", "launches": path_launches[name],
            "max_abs_err": err, "ms": entry["kernel"]["median"],
            "plain_ms": entry["plain"]["median"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": entry["library"]["median"]})
    report["kernels"] = kernels
    report["precision_launches"] = precision_launches
    report["failures"] = FAILURES
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=2))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
