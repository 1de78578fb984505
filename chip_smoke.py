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
3b. hold the top-k select (``csrc/topk_select.cu``) against the masked
   stable sort it replaced, bit for bit: on the program's adjusted scores
   at the search cells' [256 x 1,000,000] and [512 x 45,000] and the IVF
   stage's [64 x 6,688] and [64 x 12,567] (views with a row stride among
   them), at the narrow callers' shapes through ``scoring.topk`` (two
   launches a call where ``fits``, none for k > 32 there), on adversarial
   rows (constant, integer ties, +-0.0, +-inf, NaNs, ascending,
   descending) at widths 1 to 1,000,000 under all-dead, mostly-dead,
   3-live and half-live masks, k 1 to 64; its launch pair once per replay
   of a captured plan;
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
   (random codes, 1,024 balanced cells, nprobe 16): timing only;
8. HNSW and hybrid search, after phase 7's indexes are dropped.  8a:
   ``build(index="hnsw")`` of the first 8,192 phase-4 rows at the
   reference's Table 2 configuration (m 16, ef_construction 128), its
   seconds split into rotation, encode and host graph; ef 64 and 192 over
   the 640 queries: launches (B2, B4, no full scan), recall@10 against
   exact f32 over the 8,192 rows and the 4-bit full scan's beside it,
   recall and ids against the CPU plain search of the card-built file
   (0.01, 99%), repeat and save -> load -> search byte-identical.  8c: a
   10% allowlist and two phase-7a-style predicates at ef 128: only
   admissible ids, a valid share >= 0.95, the CPU plain path's results.
   8e: phase 6's graph / eager / bucket checks at ef 64; ``warmup(64)``
   then 10 searches capturing nothing, the launches equal to the graphs'
   tallies times their replays; block replays and loop iterations a
   search; graph and eager latency in turns, the graphs' device time by
   CUDA events and the idle estimate, beside the 8,192-row full scan.  8b:
   two card builds of 2,048 rows at the defaults (``recommended_m``,
   ef_construction 100) equal graphs and file bytes; neighbour entries and
   codes differing from a CPU plain build (reported).  8d: add 512 rows and
   delete 200 (no tombstoned id, the CPU's results), v8 round trips,
   compact keeping m and ef_construction with the CPU compaction's recall;
   a 2-bit HNSW with an added segment (B5, B3).  8f: hybrid dense + BM25
   over the phase-4 corpus with seeded docs (topic terms, shared and
   non-ASCII words) and each query's text from the doc of its source row:
   batched and single searches, plain, ``where=`` and an allowlist, ids
   equal to the CPU plain path's; ``MicroBatcher`` ``text=`` requests in
   one execution; batch latency split into the dense replay and the host
   BM25 + RRF.
9. recall-targeted autotune through the engine's graphs (every rung, oracle
   and boost probe a replay), each sweep between a reset and a read of the
   launch counters, with its seconds, captures and ``memory_reserved``
   before, after and after a gc.  9a: IVF over the phase-4 corpus with phase
   7a's columns (nlist 64), ``autotune(0.95, k=10, n_queries=32)``: the
   nprobe ladder with nprobe = nlist at recall 1.0 exactly, the boost
   curve, a second autotune equal, v11 files byte-identical, the loaded
   index resolving and searching with the tuned nprobe, the chosen and
   ceiling rungs against the CPU plain path of the card-written file (0.01,
   99%), a ~1% ``where=`` search boosted (``engine.boost_applied``) and
   byte-equal to the allowlist oracle at the boosted nprobe, its exact
   count the host's, and no capture after a warm-up (the stand-in meets
   0.95 only at nprobe = nlist, which leaves nothing to boost, so a second
   sweep at a 0.7 target drives the boost).  9b: the same on the
   sign cascade's rescore_mult ladder, whose last rung collapses to the
   full-scan plan.  9c (run inside phase 8, on the 8a index): the ef ladder
   10 .. 1024, the ef 1024 rung's beam iterations and device time, its
   recall@10 against exact, level-0 reachability.  9d: the reference's
   autotune benchmark at its smoke shape on the legacy threefry stream,
   card and CPU plain path: equal TuneResults, recalls 0.9625 / 0.55 / 1.0,
   tuned and safe batch latency.

10. sharded retrieval and the serving CLI, after phase 9's indexes are
    dropped.  10a: the phase-4 stand-in with phase 7a's columns and sign
    codes, sharded over ``make_local_mesh()`` (one card) and over 4 and 7
    shards on it (45,000 % 7 != 0: the last shard padded): full scans and
    the ~1% and 12.5% ``where=`` searches byte-equal to the unsharded
    graph replay, no padding id; the sign cascade at rescore_mult 8 and 32
    on 1 shard byte-equal to the unsharded cascade, on 4 against the CPU
    plain path over the same 4-shard mesh (99% of ids), with both recalls;
    rm * k >= n the plain sharded scan's bytes; 0 captures after each
    warm-up; batch median / p90 and graph device time unsharded and at 1, 4
    and 7 shards; a tuned v11 file loaded through ``ShardedMonaVec.load``
    searching at its tuned knob.  10b: ``python -m
    repro_torch.launch.serve`` in-process at 45,000 x 1024: the lifecycle
    (filter, mutate, compact, micro-batch, traces, metrics files), the
    sharded filtered cascade, IVF with autotune then its reload: every
    measured window 0 misses and 0 captures, the JSON's histograms, the
    reload's tuned knobs, each phase's QPS.
11. the determinism audit, after phase 10's indexes are dropped, in a child
    process whose environment adds ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (a
    cuBLAS call under ``torch.use_deterministic_algorithms(True)`` needs it
    before its handle exists; the other phases run without it).  11a:
    ``repro_torch.analysis.audit`` on the card (21 grid points through the
    engine's graphs, the op audit of every stage the warm-ups reported,
    coverage, the recapture pass, lint): 0 active findings and 0 stale
    allowlist entries, each of B1-B7 launched over the grid, the capture
    count beside the CPU run's, and ``--inject-hazard`` exiting non-zero
    naming const-array and full-scan-dot.  11b: a full-width probe on the
    stand-in (64 queries, k 10): the 4-bit and 2-bit full scans, the sign
    and crumb cascades at rescore_mult 32, IVF at nprobe 16, phase 7a's ~1%
    ``where=``, 4 shards on the card, HNSW at 2,048 rows and ef 64, hybrid;
    each searched twice (a capture, then a replay) and through its eager
    stages with the flag off, then again on indexes built under the flag
    (which also fills every uninitialised allocation): every result byte-
    identical, and two builds under the flag writing byte-identical files.
12. the model zoo's serving forwards, after phase 11, in a child process
    with phase 11's environment; every model's weights seeded on the card.
    12a: llama3.2-3b at full width: prefill 4 x 512 then 32 decode steps
    against the forward of the 544 tokens, in bf16 (within twice the bf16
    forward's own distance from the f32 forward) and on an f32 copy of the
    weights (the reference's test tolerance), each run twice byte for byte;
    then batch 8 at max_len 1,024 for 64 steps from empty in the bf16 and
    the 4-bit cache: B2 4 launches a layer a step, one step's B2 outputs in
    ``_rotate`` / ``_unrotate`` byte-equal to the butterfly, that step's
    codes against the CPU plain path's, two runs byte-identical, argmax
    agreement and max logit diff, tokens/s, cache bytes, one traced step
    each.  12b: the two-tower cell at full width: 1,000,000 items embedded
    and encoded (B2), 1 and 64 users retrieved (B2, B1), ids against the CPU
    plain path over the same codes (99%), the exact f32 top-10's overlap,
    latency by CUDA events.  12c: every other arch at its smoke config on
    the card against the CPU plain forward (LMs: forward, decode over both
    caches; GIN full and sampled; the recsys forwards), and qwen1.5-0.5b,
    gemma2-2b and olmoe-1b-7b at full width as 12a's first part.
13. training, after phase 12, in a child process with phase 11's
    environment, under ``torch.use_deterministic_algorithms(True)``.  13a:
    llama3.2-3b at full width (remat "full", loss_chunk 2048, AdamW
    defaults) trains 8 steps of 2 x 4,096 tokens twice from the same seeded
    weights: every loss finite, the two runs' losses and every parameter's
    and moment's bytes equal; step time by CUDA events, tokens/s, peak
    memory, one traced eager step.  13b: the same config cut to 2 layers
    (bf16, every width kept): 12 steps of 1 x 512 with a checkpoint every 4
    (keep 2) against a run that crashes at step 9 and resumes at 8 from its
    files: losses, parameters and moments byte-identical, bf16 leaves
    restored; checkpoint bytes, save and restore seconds; then one f32 step
    on the card against the CPU plain path.  13c: two-tower-retrieval at
    full width trains 8 steps of 65,536 twice byte for byte, then serves as
    12b from its retrained towers (B2 encode, B2 + B1 retrieval, ids against
    the CPU plain path).  13d: one step of every other arch's smoke config
    (the four other LMs, GIN full / sampled / graph readout, DLRM, DIEN, FM)
    against the CPU plain path, each card step twice byte for byte, and
    ``python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 8``
    in-process twice (its loss falls, the runs are byte-identical).

Launch counters count kernels that ran: a replay adds its graph's tally.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --topk-select PATH`` runs phase 3b's checks alone
and then what the full run has no time for: the top-k select against the
sort at widths 64 to 16,384, and its times beside the sort's, its plain
version's and ``torch.topk``'s at the cells', the IVF stage's and the
narrow callers' shapes; the report goes to PATH, and the exit code is 1
when a check failed.
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
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The CPU plain paths compared against below run MKL; one code path on every
# host makes their figures the same from host to host (ROADMAP C, C1).
# Set before torch is imported.
os.environ.setdefault("MKL_CBWR", "AVX2")

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
# Phase 8: HNSW at the reference's Table 2 configuration
# (benchmarks/paper_tables.py:49-57: the first 8,192 rows, m 16,
# ef_construction 128, search ef 192), and hybrid dense + BM25 search.
HNSW_N, HNSW_M, HNSW_EFC = 8192, 16, 128
HNSW_EFS = (64, 192)
HNSW_SMALL = 2048                      # 8b / 8d: the defaults (recommended_m, 100)
HNSW_2BIT_N = 1024                     # 8d: a 2-bit HNSW (B5, and B3 after an add)
HNSW_ADD, HNSW_DELETE = 512, 200       # 8d
HNSW_FILTER_EF = 128                   # 8c: the reference's filtered-HNSW test's ef
# Phase 9: autotune(recall_target, k, n_queries), the reference's defaults.
TUNE_TARGET, TUNE_K, TUNE_QUERIES = 0.95, 10, 32
BOOST_TARGET = 0.7     # 9a: a target the stand-in's IVF meets below nprobe = nlist
# Phase 11: the determinism audit and the full-width probe (child process).
PHASE11_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
PHASE11_TIMEOUT_S = 480
PROBE_QUERIES = 64                      # 11b: one batch of the phase-4 queries
# Phase 12: the model zoo's serving forwards (child process, same environment
# as phase 11's so cuBLAS is reproducible run to run).
PHASE12_ENV = PHASE11_ENV
PHASE12_TIMEOUT_S = 600
# Decode against the forward of the same tokens: in f32, the reference's own
# test tolerance (tests/test_models_smoke.py: rtol 2e-2, atol 2e-4).  In bf16,
# the forward's, the prefill's and the decode's max |logit diff| from the f32
# forward of an f32 copy of the same weights, each within a fixed limit, about
# twice the distances measured on an H100 (PERF.md): ZOO_BF16_LIMIT (llama /
# qwen / gemma forwards 0.0747 / 0.0715 / 0.0874).  An MoE model's own routing
# differs from the f32 model's for a few tokens (a bf16 near-tie moves the
# top-k), so its own distances get ZOO_BF16_MOE_LIMIT (olmoe 0.2315), and its
# forward with the f32 forward's routing replayed is held to ZOO_BF16_LIMIT.
ZOO_F32_RTOL, ZOO_F32_ATOL = 2e-2, 2e-4
ZOO_BF16_LIMIT, ZOO_BF16_MOE_LIMIT = 0.15, 0.4
ZOO_SMOKE_TOL = 1e-4     # f32 smoke: card vs CPU plain forward, rtol = atol
ZOO_SMOKE_Q_TOL = 2e-2   # f32 smoke through the 4-bit cache (butterfly vs Kronecker codes)
# Phase 13: training on the card (child process, phase 11's environment, under
# torch.use_deterministic_algorithms(True)).  One AdamW step at TRAIN_LR on
# the card against the CPU plain path: the loss within TRAIN_LOSS_RTOL, the
# global gradient norm within TRAIN_NORM_RTOL (summation orders differ; both
# read <= 3.3e-7 in f32), every gradient leaf within TRAIN_GRAD_REL of the
# CPU's (its relative L2 distance, and its max |diff| over the leaf's max
# |g|, each scale floored at TRAIN_GRAD_FLOOR of the whole gradient's: a
# zero, negated or misscaled gradient on any leaf above that floor reads
# ~1; read <= 1.2e-5), every
# parameter within TRAIN_PARAM_ATOL_LR x lr (a gradient element near zero may
# take the other sign and move its parameter by 2 lr; at step 1 AdamW moves
# each parameter by ~lr whatever its gradient, so this bound alone tests
# little), and the elements beyond TRAIN_TIGHT_TOL at most TRAIN_FAR_SHARE of
# them or TRAIN_FAR_MIN (read: 5.5e-5-1.3e-4 of them).
PHASE13_ENV = PHASE11_ENV
PHASE13_TIMEOUT_S = 600
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-5
TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-4
TRAIN_PARAM_ATOL_LR, TRAIN_TIGHT_TOL = 2.5, 1e-6
TRAIN_FAR_SHARE, TRAIN_FAR_MIN = 2.5e-4, 4
DIGEST_SLICE = 1 << 26   # elements a slice of tensor_digest's sums
HYBRID_WORDS = ("report", "market", "team", "season", "price", "study", "city", "data",
                "café", "naïve", "straße", "北京", "東京", "données", "über", "año")

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


def exact_topk(scores, k: int) -> tuple:
    """The exact top-k of the last axis by a plain stable descending sort, cut
    to k: the yardstick of the recall checks and of the top-k select, so it
    shares no code with the program's ``scoring.topk``."""
    import torch

    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def device_ms(fn, calls: int = 10, samples: int = 5, cap_s: float = 2.0) -> float:
    """Device ms a call: CUDA events around ``calls`` back-to-back calls
    queued behind a spin kernel, so the card runs them without waiting for
    the host; the median of ``samples``.  The spin is doubled until the host
    has queued every call before it ends (the events' first gap proves it),
    up to ``cap_s`` seconds: a call that waits for the card itself never
    gets ahead of any spin, and is then timed behind the longest one with
    the host's gaps counted (said on the log)."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin, cap, times, capped = int(1e-3 * SM_CLOCK_HZ), int(cap_s * SM_CLOCK_HZ), [], False
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
            if spin < cap:
                spin = min(2 * spin, cap)    # the card caught up with the host
                continue
            capped = True
        times.append(marks[1].elapsed_time(marks[2]) / calls)
    if capped:
        say(f"device_ms: the host did not queue {calls} calls of "
            f"{getattr(fn, '__name__', fn)} within a {cap_s:g} s spin; its time counts the "
            f"host's gaps")
    return sorted(times)[samples // 2]


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


def profile_window(torch, fn, label: str, top: int = 10, warm_up: bool = True) -> dict:
    """Device activity (kernels and copies) over one call of ``fn`` after a
    warm-up call (unless ``warm_up`` is False: ``fn`` has run already),
    traced with torch.profiler: time by name, and the busy
    time as the union of the activity intervals over the traced window's
    wall time.  ``fn`` must replay no CUDA graph: with torch 2.11 / CUDA
    12.8, a graph replayed under the profiler's CUPTI tracing crashed the
    process (SIGSEGV in ``CUDAGraph.replay``), so graph paths are traced
    through their eager stages and timed by ``graph_device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm_up:
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
    out = {"wall_us": wall_us, "device_busy_us": busy_us, "kernels": len(acts),
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
        exact = exact_topk(exact_scores, 10)[1].cpu().numpy()   # row == id here
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


def filter_columns(np, rng, n: int) -> dict:
    """Phase 7a's metadata columns for ``n`` rows, drawn from ``rng``: an
    8-value str column, an int date and a float price."""
    return {"lang": np.array(LANGS)[rng.integers(0, len(LANGS), n)],
            "date": rng.integers(0, 1_000_000, n), "price": rng.standard_normal(n)}


def planted_columns(np, rng) -> dict:
    """``filter_columns`` of the N corpus rows with edge values planted
    (int64 min and max, -0.0, +0.0 and both infinities)."""
    i64 = np.iinfo(np.int64)
    cols = filter_columns(np, rng, N)
    cols["date"][:2] = [i64.min, i64.max]
    cols["price"][2:6] = [-0.0, 0.0, np.inf, -np.inf]
    return cols


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
        return filter_columns(np, rng, n)

    cols = planted_columns(np, rng)
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
        return exact_topk(s, 10)[1].cpu().numpy()

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


def staged_device_ms(torch, index, kw: dict, qs, replays: int = 10) -> tuple:
    """Device time of one search of 64 at k=10 with ``kw`` on a plan with
    loops (HNSW): its graphs replayed back to back with the block counts of
    that search (no host check between blocks), CUDA events around
    ``replays`` such sequences, on a fresh handle of the same tensors.
    Returns (ms, block replays of each loop)."""
    from repro_torch import MonaVec

    fresh = MonaVec(dataclasses.replace(index.backend), index.mut, index.meta)
    fresh.search(qs[:64], k=10, **kw)
    (graph,) = fresh.backend.graphs.values()
    blocks = list(graph.last_blocks)
    graph.replay_parts(blocks)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay_parts(blocks)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays, blocks


def hnsw_hybrid_phase(c) -> dict:
    """Phase 8: the HNSW backend at Table 2's configuration (build, search
    against exact and against the CPU plain path, determinism, filters,
    lifecycle, the engine's block replays) and hybrid dense + BM25 search
    with RRF fusion on the phase-4 corpus.  ``c`` carries the main phase's
    tensors and helpers."""
    torch, np, dev = c.torch, c.np, c.dev
    from repro_torch import MonaVec, engine
    from repro_torch.core import hnsw as hnsw_mod, quantize as qz, scoring
    from repro_torch.core.allowlist import Allowlist
    from repro_torch.core.bruteforce import BruteForceIndex
    from repro_torch.core.convert import encoded_from_arrays
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.metadata import MetaStore
    from repro_torch.core.predicate import Eq, Lt
    from repro_torch.core.segments import SENTINEL_ID
    from repro_torch.core.tenancy import TenantRegistry
    from repro_torch.data.synthetic import _rng

    corpus, queries, expect, say = c.corpus, c.queries, c.expect, c.say
    cpu_q = 64 * CPU_CASCADE_BATCHES          # queries of every CPU plain comparison
    out: dict = {}
    qt = torch.from_numpy(queries).to(dev)

    def exact_ids(rows: np.ndarray, live: Optional[np.ndarray] = None) -> np.ndarray:
        """Exact f32 cosine top-10 over ``rows`` (row == id), live rows only."""
        s = scoring.score_f32(qt, torch.from_numpy(rows).to(dev), "cosine")
        if live is not None:
            s[:, ~torch.from_numpy(live).to(dev)] = -float("inf")
        return exact_topk(s, 10)[1].cpu().numpy()

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

    def held_graphs(index) -> bool:
        """Every graph the index holds is the several-part form of a plan
        with loops: its searches ran as replays, not eagerly."""
        graphs = list(index.backend.graphs.values())
        return bool(graphs) and all(len(g.parts) > 2 and g.graph is None for g in graphs)

    def built(rows, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = MonaVec.build(rows, index="hnsw", **kw)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    # ---- 8a. HNSW at Table 2's configuration ------------------------------------
    t_phase = time.perf_counter()
    sub = corpus[:HNSW_N]
    exact = exact_ids(sub)
    (h, build_s), b_launch = launched(lambda: built(sub, m=HNSW_M, ef_construction=HNSW_EFC))
    be = h.backend
    secs = be.build_seconds
    levels = np.bincount(be.node_level.astype(np.int64))
    say(f"hnsw build {HNSW_N}x{DIM} m={HNSW_M} ef_construction={HNSW_EFC}: {build_s:.3f} s = "
        f"rotation (B2 and the copy to the host) {secs['rotate']:.3f} + encode "
        f"{secs['encode']:.3f} + host graph {secs['graph']:.3f}; max_level {be.max_level}, "
        f"nodes per level {levels.tolist()}, entry {be.entry_point}; launches {b_launch}")
    expect(b_launch["fwht"] == 1, f"hnsw build: the corpus is not rotated once on the card "
                                  f"({b_launch})")
    out["build"] = {"seconds": build_s, **secs, "max_level": be.max_level,
                    "levels": levels.tolist(), "launches": b_launch}
    full4 = MonaVec.build(sub)
    out["full_scan_recall_at_10"] = recall(run(full4, {})[1], exact)
    tdir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    td = Path(tdir.name)
    h.save(str(td / "h.mvec"))
    cpu_h = MonaVec.load(str(td / "h.mvec"), device="cpu")
    h_back = MonaVec.load(str(td / "h.mvec"))
    out["hnsw"] = {}
    hnsw_launches = {}
    for ef in HNSW_EFS:
        (s_card, i_card), got = launched(lambda: run(h, {"ef": ef}))
        for name, n in got.items():
            hnsw_launches[name] = hnsw_launches.get(name, 0) + n
        kernels_ok = (got["gather_nibble_dot"] > 0 and got["fwht"] > 0
                      and got["nibble_dot"] == 0 and held_graphs(h))
        s_cpu, i_cpu = cpu_h.search(queries[:cpu_q], k=10, ef=ef)
        again = run(h, {"ef": ef})
        back = run(h_back, {"ef": ef})
        e = {"launches": got, "recall_at_10": recall(i_card, exact),
             "recall_at_10_card_cpu_queries": recall(i_card[:cpu_q], exact),
             "recall_at_10_cpu": recall(i_cpu, exact),
             "ids_equal_cpu": float(np.mean(i_cpu == i_card[:cpu_q])),
             "repeat_identical": same(again, (s_card, i_card)),
             "reload_identical": same(back, (s_card, i_card))}
        say(f"hnsw ef={ef}: recall@10 {e['recall_at_10']:.4f} vs exact over {HNSW_N} rows "
            f"(the 4-bit full scan's {out['full_scan_recall_at_10']:.4f}); on the {cpu_q} CPU "
            f"queries card {e['recall_at_10_card_cpu_queries']:.4f} CPU plain (card-built "
            f"file) {e['recall_at_10_cpu']:.4f}, ids equal {e['ids_equal_cpu']:.4%}; repeat "
            f"{e['repeat_identical']}, save -> load -> search {e['reload_identical']}; "
            f"launches {got}")
        expect(kernels_ok, f"hnsw ef={ef}: launches {got} or no graph held")
        expect(abs(e["recall_at_10_card_cpu_queries"] - e["recall_at_10_cpu"]) <= 0.01,
               f"hnsw ef={ef}: recall vs the CPU plain path")
        expect(e["ids_equal_cpu"] >= 0.99, f"hnsw ef={ef}: ids differ from the CPU in over 1%")
        expect(e["repeat_identical"] and e["reload_identical"],
               f"hnsw ef={ef}: a repeat or a reload differs")
        out["hnsw"][ef] = e
    del h_back
    say(f"phase 8a: {time.perf_counter() - t_phase:.1f} s")

    # ---- 8c. filters on the 8a index ---------------------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    cols = {"lang": np.array(LANGS)[rng.integers(0, len(LANGS), HNSW_N)],
            "date": rng.integers(0, 1_000_000, HNSW_N)}
    hm = MonaVec(h.backend, meta=MetaStore.build(cols, HNSW_N))
    cpu_hm = MonaVec(cpu_h.backend, meta=hm.meta)
    tenth = np.arange(HNSW_N) % 10 == 0
    filters = {"allow_10pct": ({"allow": Allowlist(mask=tenth, n_allowed=int(tenth.sum()))},
                               tenth),
               "eq_lang": ({"where": Eq("lang", "en")},
                           np.asarray(cols["lang"] == "en")),
               "lang_date": ({"where": Eq("lang", "en") & Lt("date", 500_000)},
                             np.asarray((cols["lang"] == "en") & (cols["date"] < 500_000)))}
    out["filters"] = {}
    for name, (kw, mask) in filters.items():
        kw = dict(kw, ef=HNSW_FILTER_EF)
        s_f, i_f = run(hm, kw)
        real = i_f != SENTINEL_ID
        admissible = bool(mask[i_f[real].astype(np.int64)].all())
        s_cpu, i_cpu = cpu_hm.search(queries[:cpu_q], k=10, **kw)
        ex = exact_ids(sub, mask)
        e = {"share": float(mask.mean()), "valid_share": float(real.mean()),
             "admissible": admissible, "recall_at_10": recall(i_f, ex),
             "recall_at_10_card_cpu_queries": recall(i_f[:cpu_q], ex),
             "recall_at_10_cpu": recall(i_cpu, ex),
             "ids_equal_cpu": float(np.mean(i_cpu == i_f[:cpu_q]))}
        say(f"hnsw filter {name} ({e['share']:.2%} of rows) ef={HNSW_FILTER_EF}: valid share "
            f"{e['valid_share']:.4f}, only admissible ids {admissible}; recall@10 over the "
            f"admissible rows {e['recall_at_10']:.4f}; on the CPU queries card "
            f"{e['recall_at_10_card_cpu_queries']:.4f} CPU plain {e['recall_at_10_cpu']:.4f}, "
            f"ids equal {e['ids_equal_cpu']:.4%}")
        expect(admissible and e["valid_share"] >= 0.95,
               f"hnsw filter {name}: an inadmissible id or a valid share under 0.95")
        expect(abs(e["recall_at_10_card_cpu_queries"] - e["recall_at_10_cpu"]) <= 0.01
               and e["ids_equal_cpu"] >= 0.99, f"hnsw filter {name}: not the CPU's results")
        out["filters"][name] = e
    del hm, cpu_hm
    say(f"phase 8c: {time.perf_counter() - t_phase:.1f} s")

    # ---- 8e. the engine on the 8a index --------------------------------------------
    t_phase = time.perf_counter()
    kw64 = {"ef": HNSW_EFS[0]}
    out["engine"] = engine_checks("hnsw ef=64", h, kw64, queries)
    cache = engine.plan_cache()
    fresh = MonaVec(dataclasses.replace(h.backend), h.mut)
    cache.clear()
    searcher = fresh.searcher(k=10, **kw64)
    before = cache.stats.snapshot()
    searcher.warmup(64)
    warm = cache.stats.since(before)
    (graph,) = fresh.backend.graphs.values()
    counters = c.counters
    c.reset_counts()
    before = cache.stats.snapshot()
    blocks, want = [], {name: 0 for name in counters}
    for i in range(BATCHES):
        searcher(queries[64 * i: 64 * (i + 1)])
        blocks.append(list(graph.last_blocks))
        loops = iter(graph.last_blocks)
        for part, is_loop in graph.parts:
            n = next(loops) if is_loop else 1
            for name, counter in counters.items():
                want[name] += n * part.tally.get(counter, 0)
    after = cache.stats.since(before)
    got = c.read_counts()
    b4_per_search = want["gather_nibble_dot"] / BATCHES
    traces = []
    for i in range(BATCHES):
        trace: list = []
        q_rot = qz.encode_query(qt[64 * i: 64 * (i + 1)], be.enc)
        hnsw_mod.search_stage(q_rot, be.enc.packed, be.enc.qnorms, be.nbr0_t, be.nbr_hi_t,
                              torch.ones(HNSW_N, dtype=torch.bool, device=dev),
                              entry=be.entry_point, ef=HNSW_EFS[0], k=10, metric="cosine",
                              bits=4, n4_dims=0, max_level=be.max_level, trace=trace)
        traces.append(trace)
    say(f"engine hnsw warm-up: warmup(64) misses {warm.misses} captures {warm.captures}; "
        f"{BATCHES} searches after: misses {after.misses} captures {after.captures}; "
        f"{len(graph.parts)} graphs a plan; block replays a search (descent levels "
        f"{be.max_level}..1, beam) {blocks}; iterations per loop {traces}; launches {got} "
        f"= the tallies times the replays {want}; B4 launches a search {b4_per_search:.1f}")
    expect(warm.misses == 1 and warm.captures == 1, "engine hnsw: warmup(64) did not capture "
                                                    "exactly once")
    expect(after.misses == 0 and after.captures == 0,
           "engine hnsw: searches after the warm-up minted a plan or a graph")
    expect(got == want and got["gather_nibble_dot"] > 0,
           "engine hnsw: launches are not the replays' tallies")
    out["engine"].update(warmup=dataclasses.asdict(warm), after=dataclasses.asdict(after),
                         block_replays=blocks, iterations=traces, launches=got,
                         b4_per_search=b4_per_search, graphs_per_plan=len(graph.parts))
    del fresh, searcher, graph
    runs = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "graph", "eager"):
        fn = ((lambda qb: h.search(qb, k=10, **kw64)) if mode == "graph"
              else (lambda qb: search_eager(h, qb, **kw64)))
        runs[mode].append(batch_latencies(fn, queries, 20))
    dev_ms, dev_blocks = staged_device_ms(torch, h, kw64, queries)
    full_lat = batch_latencies(lambda qb: full4.search(qb, k=10), queries, 20)
    full_dev = graph_device_ms(torch, full4, {}, queries)
    g, e_ = runs["graph"], runs["eager"]
    idle = max(0.0, 1.0 - dev_ms / g[0]["median_ms"])
    say(f"turns hnsw ef=64: batch median graph {g[0]['median_ms']:.4f} / "
        f"{g[1]['median_ms']:.4f} ms, eager {e_[0]['median_ms']:.4f} / "
        f"{e_[1]['median_ms']:.4f} ms; p90 graph {g[0]['p90_ms']:.4f} / {g[1]['p90_ms']:.4f}, "
        f"eager {e_[0]['p90_ms']:.4f} / {e_[1]['p90_ms']:.4f} ms; graphs' device time "
        f"{dev_ms:.4f} ms a search (blocks {dev_blocks}), idle share estimate {idle:.3f}; "
        f"the 4-bit full scan of the same {HNSW_N} rows: median {full_lat['median_ms']:.4f} ms, "
        f"graph device {full_dev:.4f} ms")
    out["timing"] = {"graph": g, "eager": e_, "graph_device_ms": dev_ms,
                     "device_blocks": dev_blocks, "idle_share_estimate": idle,
                     "full_scan": full_lat, "full_scan_device_ms": full_dev}
    lat192 = batch_latencies(lambda qb: h.search(qb, k=10, ef=HNSW_EFS[1]), queries, 20)
    dev192, blocks192 = staged_device_ms(torch, h, {"ef": HNSW_EFS[1]}, queries)
    say(f"hnsw ef=192: batch median {lat192['median_ms']:.4f} ms p90 {lat192['p90_ms']:.4f} ms; "
        f"device {dev192:.4f} ms (blocks {blocks192})")
    out["timing"]["ef192"] = {"latency": lat192, "graph_device_ms": dev192,
                              "device_blocks": blocks192}
    say(f"phase 8e: {time.perf_counter() - t_phase:.1f} s")
    # Phase 9c tunes the 8a index before it is dropped (its graph took a
    # minute of host work to build).
    out["tune"] = hnsw_tune_phase(c, h, sub, exact, recall, run)
    t_phase = time.perf_counter()
    del full4, cpu_h, h, be
    torch.cuda.empty_cache()

    # ---- 8b. determinism at the defaults -------------------------------------------
    t_phase = time.perf_counter()
    small = corpus[:HNSW_SMALL]
    a, a_s = built(small)
    b, b_s = built(small)
    cpu_a = MonaVec.build(small, index="hnsw", device="cpu")
    a.save(str(td / "a.mvec"))
    b.save(str(td / "b.mvec"))
    ab, cb = a.backend, cpu_a.backend
    graphs_equal = (ab.neighbors0.tobytes() == b.backend.neighbors0.tobytes()
                    and ab.neighbors_hi.tobytes() == b.backend.neighbors_hi.tobytes()
                    and (ab.entry_point, ab.max_level) == (b.backend.entry_point,
                                                           b.backend.max_level))
    files_equal = (td / "a.mvec").read_bytes() == (td / "b.mvec").read_bytes()
    nbr_diff = int((ab.neighbors0 != cb.neighbors0).sum())
    if ab.neighbors_hi.shape == cb.neighbors_hi.shape:
        nbr_diff += int((ab.neighbors_hi != cb.neighbors_hi).sum())
    else:
        nbr_diff = -1
    unpack = qz.unpack_4bit
    flips = int((unpack(ab.enc.packed).cpu() != unpack(cb.enc.packed)).sum())
    flip_rows = int((unpack(ab.enc.packed).cpu() != unpack(cb.enc.packed)).any(dim=1).sum())
    out["determinism"] = {"m": ab.m, "ef_construction": ab.ef_construction,
                          "build_s": [a_s, b_s], "graphs_equal": graphs_equal,
                          "files_equal": files_equal,
                          "neighbour_entries_differing_cpu": nbr_diff,
                          "code_flips_cpu": flips, "code_flip_rows_cpu": flip_rows,
                          "cpu_build_seconds": cb.build_seconds}
    say(f"hnsw determinism {HNSW_SMALL} rows, m={ab.m} (recommended_m) ef_construction="
        f"{ab.ef_construction}: builds {a_s:.3f} / {b_s:.3f} s; two card builds give equal "
        f"graphs {graphs_equal} and byte-identical files {files_equal}; against the CPU plain "
        f"build: {nbr_diff} neighbour entries differ (-1: another top level), {flips} codes "
        f"flip in {flip_rows} rows (reported)")
    expect(ab.m == MonaVec.recommended_m(HNSW_SMALL) and graphs_equal and files_equal,
           "hnsw determinism: two card builds differ")
    del b, cpu_a
    say(f"phase 8b: {time.perf_counter() - t_phase:.1f} s")

    # ---- 8d. lifecycle on the 8b index --------------------------------------------
    t_phase = time.perf_counter()
    a.add(corpus[HNSW_SMALL: HNSW_SMALL + HNSW_ADD])
    ids = a.ids
    dead = ids[::(HNSW_SMALL + HNSW_ADD) // HNSW_DELETE][:HNSW_DELETE]
    n_dead = a.delete(dead)
    (s_m, i_m), got = launched(lambda: run(a, {"ef": 64}))
    no_dead = not np.isin(i_m, dead).any()
    a.save(str(td / "a8.mvec"))
    a8 = MonaVec.load(str(td / "a8.mvec"))
    a8.save(str(td / "a8b.mvec"))
    v8_ok = ((td / "a8.mvec").read_bytes()[4] == 8
             and same(a8.search(queries[:64], k=10, ef=64), (s_m[:64], i_m[:64]))
             and (td / "a8.mvec").read_bytes() == (td / "a8b.mvec").read_bytes())
    cpu_a8 = MonaVec.load(str(td / "a8.mvec"), device="cpu")
    live_rows = ~np.isin(np.arange(HNSW_SMALL + HNSW_ADD), dead)
    ex = exact_ids(corpus[:HNSW_SMALL + HNSW_ADD], live_rows)
    s_cpu, i_cpu = cpu_a8.search(queries[:cpu_q], k=10, ef=64)
    reclaimed = a.compact()
    cpu_a8.compact()
    c_card = run(a, {"ef": 64})[1]
    c_cpu = cpu_a8.search(queries[:cpu_q], k=10, ef=64)[1]
    e = {"deleted": n_dead, "launches": got, "no_tombstoned_id": no_dead,
         "recall_at_10": recall(i_m, ex),
         "recall_at_10_card_cpu_queries": recall(i_m[:cpu_q], ex),
         "recall_at_10_cpu": recall(i_cpu, ex),
         "ids_equal_cpu": float(np.mean(i_cpu == i_m[:cpu_q])), "v8_round_trip": v8_ok,
         "compact_reclaimed": reclaimed, "compact_m": a.backend.m,
         "compact_ef_construction": a.backend.ef_construction,
         "compact_recall_at_10": recall(c_card, ex),
         "compact_recall_at_10_card_cpu_queries": recall(c_card[:cpu_q], ex),
         "compact_recall_at_10_cpu": recall(c_cpu, ex),
         "compact_ids_equal_cpu": float(np.mean(c_cpu == c_card[:cpu_q]))}
    say(f"hnsw lifecycle: add {HNSW_ADD}, delete {n_dead}; ef=64 launches {got}; no tombstoned "
        f"id {no_dead}; recall@10 {e['recall_at_10']:.4f}, CPU plain {e['recall_at_10_cpu']:.4f}"
        f" (ids equal {e['ids_equal_cpu']:.4%}); v8 save -> load -> search and -> save "
        f"byte-identical {v8_ok}; compact reclaimed {reclaimed}, m {a.backend.m} "
        f"ef_construction {a.backend.ef_construction}, recall@10 {e['compact_recall_at_10']:.4f}"
        f", on the CPU queries card {e['compact_recall_at_10_card_cpu_queries']:.4f} CPU plain "
        f"compact {e['compact_recall_at_10_cpu']:.4f} (ids equal "
        f"{e['compact_ids_equal_cpu']:.4%})")
    expect(n_dead == HNSW_DELETE and no_dead and v8_ok and reclaimed == HNSW_DELETE,
           "hnsw lifecycle: a check failed")
    expect(got["nibble_dot"] > 0 and got["gather_nibble_dot"] > 0 and got["fwht"] > 0,
           f"hnsw lifecycle: launches {got}")
    expect(e["ids_equal_cpu"] >= 0.99
           and abs(e["recall_at_10_card_cpu_queries"] - e["recall_at_10_cpu"]) <= 0.01,
           "hnsw lifecycle: not the CPU's results")
    expect(a.backend.m == ab.m and a.backend.ef_construction == ab.ef_construction
           and abs(e["compact_recall_at_10_card_cpu_queries"]
                   - e["compact_recall_at_10_cpu"]) <= 0.01,
           "hnsw compact: m, ef_construction or recall is not the CPU's")
    out["lifecycle"] = e
    lifecycle_launches = got
    del a, a8, cpu_a8, ab, cb
    # A 2-bit HNSW: its beam on B5, its extra segment's scan on B3.
    two, _ = built(corpus[:HNSW_2BIT_N], bits=2, m=HNSW_M, ef_construction=HNSW_EFC)
    two.add(corpus[HNSW_2BIT_N: HNSW_2BIT_N + 64])
    (_, i2), got2 = launched(lambda: run(two, {"ef": 64}))
    e2 = {"launches": got2, "recall_at_10": recall(i2, exact_ids(
        corpus[:HNSW_2BIT_N + 64]))}
    say(f"hnsw 2-bit {HNSW_2BIT_N} + 64 rows: recall@10 {e2['recall_at_10']:.4f}; launches "
        f"{got2}")
    expect(got2["gather_crumb_dot"] > 0 and got2["crumb_dot"] > 0
           and got2["gather_nibble_dot"] == 0 and held_graphs(two),
           f"hnsw 2-bit: launches {got2}")
    out["hnsw_2bit"] = e2
    del two
    tdir.cleanup()
    torch.cuda.empty_cache()
    say(f"phase 8d: {time.perf_counter() - t_phase:.1f} s")

    # ---- 8f. hybrid dense + BM25 --------------------------------------------------
    t_phase = time.perf_counter()
    # Each row's doc: its topic's terms (the stand-in's cluster, drawn as
    # embedding_corpus draws it), shared and non-ASCII words; each query's
    # text: words of the doc of the row queries_from_corpus copied.
    g = _rng(SEED, 0, 2)
    g.standard_normal((64, DIM))
    topic = g.integers(0, 64, size=N)
    src = _rng(SEED + 1, 1, 4).integers(0, N, size=len(queries))
    trng = np.random.default_rng(SEED + 11)
    words = np.array(HYBRID_WORDS)
    docs = [" ".join([f"topic{t}", f"term{t}x{trng.integers(0, 4)}"]
                     + list(words[trng.integers(0, len(words), trng.integers(2, 7))]))
            for t in topic]
    texts = [" ".join(docs[r].split()[:3]) for r in src]
    hcols = {"lang": np.array(LANGS)[trng.integers(0, len(LANGS), N)]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hy = HybridIndex.build(corpus, docs, meta=hcols)
    torch.cuda.synchronize()
    hy_build = time.perf_counter() - t0
    de = hy.dense.enc
    cpu_hy = HybridIndex(dense=BruteForceIndex(enc=encoded_from_arrays(
        de.packed.cpu().numpy(), de.qnorms.cpu().numpy(), seed=de.seed, metric="cosine",
        bits=4, dim=DIM, dim_pad=de.dim_pad, device="cpu"), ids=hy.dense.ids),
        sparse=hy.sparse, meta=hy.meta)
    mask = np.arange(N) % 4 == 0
    allow = Allowlist(mask=mask, n_allowed=int(mask.sum()))
    cases = {"plain": {}, "where": {"where": Eq("lang", "en")}, "allow": {"allow": allow}}
    out["hybrid"] = {"build_s": hy_build}
    hybrid_launches = None
    for name, kw in cases.items():
        res, got = launched(lambda: [hy.search(queries[64 * i: 64 * (i + 1)],
                                               texts[64 * i: 64 * (i + 1)], 10, **kw)
                                     for i in range(BATCHES)])
        if hybrid_launches is None:
            hybrid_launches = got
        ids_card = np.concatenate([r[1] for r in res])
        ids_cpu = np.concatenate([cpu_hy.search(queries[64 * i: 64 * (i + 1)],
                                                texts[64 * i: 64 * (i + 1)], 10, **kw)[1]
                                  for i in range(CPU_CASCADE_BATCHES)])
        single = [hy.search(queries[i], texts[i], 10, **kw) for i in range(8)]
        single_ok = all(s_[1].ndim == 1 and s_[1].tobytes()
                        == ids_card[i, :s_[1].shape[0]].tobytes()
                        for i, s_ in enumerate(single))
        single_cpu = all(s_[1].tobytes() == cpu_hy.search(queries[i], texts[i], 10, **kw)[1]
                         .tobytes() for i, s_ in enumerate(single))
        real = ids_card[ids_card >= 0]
        if name == "where":
            admissible = bool((hcols["lang"][real] == "en").all())
        elif name == "allow":
            admissible = bool(mask[real].all())
        else:
            admissible = True
        cpu_equal = ids_cpu.tobytes() == ids_card[:cpu_q].tobytes()
        say(f"hybrid {name}: ids equal to the CPU plain path on {cpu_q} queries {cpu_equal}; "
            f"single queries = their batched rows {single_ok}, = the CPU's {single_cpu}; "
            f"only admissible ids {admissible}; launches {got}")
        expect(cpu_equal and single_ok and single_cpu and admissible,
               f"hybrid {name}: not the CPU plain path's ids, or an inadmissible id")
        expect(got["nibble_dot"] > 0 and got["fwht"] > 0 and bool(hy.dense.graphs),
               f"hybrid {name}: the dense channel did not replay its graph ({got})")
        out["hybrid"][name] = {"cpu_equal": cpu_equal, "single_ok": single_ok,
                               "single_cpu": single_cpu, "admissible": admissible,
                               "launches": got}
    reg = TenantRegistry()
    reg.put("t", "docs", hy)
    mb = engine.MicroBatcher(reg)
    tickets = [mb.submit("t", "docs", queries[:3], k=10, text=texts[:3]),
               mb.submit("t", "docs", queries[3:4], k=10, text=texts[3]),
               mb.submit("t", "docs", queries[4:9], k=10, text=texts[4:9])]
    flushes = mb.flush()
    direct = hy.search(queries[:9], texts[:9], 10)
    cat = np.concatenate([t.result()[1] for t in tickets])
    batched_ok = flushes == 1 and cat.tobytes() == direct[1].tobytes()
    say(f"hybrid MicroBatcher text=: 3 requests in {flushes} execution(s), rows = the direct "
        f"batched search {batched_ok}")
    expect(batched_ok, "hybrid MicroBatcher: not one execution or not the direct rows")
    dense_lat = batch_latencies(lambda qb: engine.search_backend(
        hy.dense, None, qb, 20, meta=hy.meta), queries, 20)
    qi = {"i": 0}

    def hybrid_batch(qb):
        i = qi["i"] % BATCHES
        qi["i"] += 1
        return hy.search(queries[64 * i: 64 * (i + 1)], texts[64 * i: 64 * (i + 1)], 10)

    hy_lat = batch_latencies(hybrid_batch, queries, 20)
    host_ms = hy_lat["median_ms"] - dense_lat["median_ms"]
    say(f"hybrid timing (batch of 64, fetch_k 20): median {hy_lat['median_ms']:.4f} ms p90 "
        f"{hy_lat['p90_ms']:.4f} ms = dense replay {dense_lat['median_ms']:.4f} ms (p90 "
        f"{dense_lat['p90_ms']:.4f}) + host BM25 and RRF ~{host_ms:.4f} ms "
        f"({host_ms / 64:.4f} ms a query); build {hy_build:.2f} s")
    out["hybrid"].update(latency=hy_lat, dense_latency=dense_lat, host_ms=host_ms,
                         batcher_ok=batched_ok)
    del hy, cpu_hy, reg, mb
    torch.cuda.empty_cache()
    say(f"phase 8f: {time.perf_counter() - t_phase:.1f} s")
    out["launches"] = {"hnsw": hnsw_launches, "hnsw_lifecycle": lifecycle_launches,
                       "hnsw_2bit": got2, "hybrid": hybrid_launches}
    return out


def tune_sweep(c, index, label: str, target: float = TUNE_TARGET) -> dict:
    """``index.autotune`` at phase 9's arguments (recall ``target``) between
    a reset and a read of the kernels' counters: its seconds, launches,
    plan-cache captures, the reserved card memory before and after the
    sweep and after a gc and ``empty_cache``, and the result (ladder,
    chosen knob, boost curve)."""
    torch = c.torch
    from repro_torch import engine

    cache = engine.plan_cache()
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_reserved()]
    before = cache.stats.snapshot()
    c.reset_counts()
    t0 = time.perf_counter()
    index.autotune(recall_target=target, k=TUNE_K, n_queries=TUNE_QUERIES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = c.read_counts()
    delta = cache.stats.since(before)
    mem.append(torch.cuda.memory_reserved())
    gc.collect()
    torch.cuda.empty_cache()
    mem.append(torch.cuda.memory_reserved())
    t = index.tuned
    ((knob, rungs),) = t.ladder.items()
    out = {"seconds": secs, "launches": launches, "captures": delta.captures,
           "plans": delta.misses, "evictions": delta.evictions,
           "reserved_mib": [m / 2 ** 20 for m in mem], "graphs_held": len(index.backend.graphs),
           "knob": knob, "chosen": t.knobs[knob], "met_target": t.met_target,
           "ladder": [[r.value, r.recall] for r in rungs],
           "boost": None if t.boost is None else [[p.selectivity, p.mult, p.recall]
                                                  for p in t.boost.points]}
    say(f"{label}: autotune(recall_target={target}, k={TUNE_K}, n_queries={TUNE_QUERIES}) "
        f"{secs:.3f} s; {knob} ladder {[(v, round(r, 6)) for v, r in out['ladder']]}; chosen "
        f"{out['chosen']} (met_target {t.met_target}); boost (selectivity, mult, recall) "
        f"{out['boost']}; captures {delta.captures}, new plans {delta.misses}, evictions "
        f"{delta.evictions}, graphs the index holds {out['graphs_held']}; memory_reserved "
        f"{mem[0] / 2 ** 20:.1f} -> {mem[1] / 2 ** 20:.1f} MiB, after gc and empty_cache "
        f"{mem[2] / 2 ** 20:.1f} MiB; launches {launches}")
    return out


def held_graph_mib(c, index) -> tuple:
    """(graphs ``index`` holds, the reserved card memory in MiB that
    dropping them frees), after a gc and ``empty_cache``; the graphs are
    gone after."""
    torch = c.torch
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    n = len(index.backend.graphs)
    index.backend.graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return n, (before - torch.cuda.memory_reserved()) / 2 ** 20


def tune_checks(c, index, sweep: dict, td: Path, name: str) -> dict:
    """Phase 9's checks of a tuned index: a second autotune gives an equal
    result; v11 files: two saves hash equal, save -> load -> save byte-equal;
    the loaded index resolves the tuned knob and searches as with it given
    explicitly; the chosen and ceiling rungs on the card against the CPU
    plain path of the card-written file over the sample queries (each side
    against its own full-scan oracle)."""
    np = c.np
    from repro_torch import MonaVec
    from repro_torch.core.bruteforce import BruteForceIndex
    from repro_torch.engine.plan import search_backend
    from repro_torch.tune import measure_recall, sample_queries

    first = index.tuned
    knob, chosen = sweep["knob"], sweep["chosen"]
    again = tune_sweep(c, index, f"{name} again")
    out = {"again_equal": index.tuned == first, "again_captures": again["captures"],
           "again_seconds": again["seconds"]}
    index.tuned = first
    paths = [td / f"{name}-{i}.mvec" for i in range(3)]
    index.save(str(paths[0]))
    index.save(str(paths[1]))
    back = MonaVec.load(str(paths[0]))
    back.save(str(paths[2]))
    raw = [p.read_bytes() for p in paths]
    out["v11_identical"] = raw[0][4] == 11 and raw[0] == raw[1] == raw[2]
    qb = c.queries[:64]
    out["loaded_resolves"] = (back.tuned == first
                              and back.resolved_knobs(TUNE_K) == {knob: chosen})
    out["loaded_search_explicit"] = (
        same_result(back.search(qb, k=TUNE_K), back.search(qb, k=TUNE_K, **{knob: chosen}))
        and same_result(back.search(qb, k=TUNE_K), index.search(qb, k=TUNE_K)))
    del back
    cpu = MonaVec.load(str(paths[0]), device="cpu")
    qs = sample_queries(index, TUNE_QUERIES, first.seed)

    def oracle(ix):
        return search_backend(BruteForceIndex(enc=ix.backend.enc, ids=ix.backend.ids), None,
                              qs, TUNE_K)[1]

    gold_card, gold_cpu = oracle(index), oracle(cpu)
    ladder = dict((v, r) for v, r in sweep["ladder"])
    out["cpu"] = {}
    for v in sorted({chosen, sweep["ladder"][-1][0]}):
        card_ids = index.search(qs, TUNE_K, **{knob: v})[1]
        cpu_ids = cpu.search(qs, TUNE_K, **{knob: v})[1]
        e = {"recall_card": measure_recall(card_ids, gold_card),
             "recall_ladder": ladder[v], "recall_cpu": measure_recall(cpu_ids, gold_cpu),
             "ids_equal_cpu": float(np.mean(card_ids == cpu_ids))}
        out["cpu"][v] = e
        c.expect(abs(e["recall_card"] - e["recall_cpu"]) <= 0.01
                 and e["ids_equal_cpu"] >= 0.99 and e["recall_card"] == ladder[v],
                 f"{name} {knob}={v}: the card's rung is not the CPU plain path's or the "
                 f"ladder's")
    say(f"{name}: second autotune equal {out['again_equal']} ({again['captures']} captures, "
        f"{again['seconds']:.3f} s); v11 two saves and save -> load -> save byte-identical "
        f"{out['v11_identical']}; loaded index resolves {knob}={chosen} "
        f"{out['loaded_resolves']} and searches as with it explicit "
        f"{out['loaded_search_explicit']}; card against the CPU plain path of the card-written "
        f"file over the {len(qs)} sample queries {out['cpu']}")
    c.expect(out["again_equal"] and out["v11_identical"] and out["loaded_resolves"]
             and out["loaded_search_explicit"], f"{name}: a repeat, file or reload check failed")
    del cpu
    return out


def boost_checks(c, index, knob: str, p, label: str, must_boost: bool) -> dict:
    """A ``where=`` search of the tuned ``index`` at ~1% selectivity: the
    exact count equals the host count, the boost is applied once a search
    when the curve's multiplier exceeds 1 (``engine.boost_applied``; with
    ``must_boost`` it must), the ids are the ``Allowlist(evaluate mask)``
    oracle's at the boosted knob byte for byte, and after a warm-up 10
    tuned and 10 boosted searches capture nothing."""
    torch, np, dev = c.torch, c.np, c.dev
    from repro_torch import engine, obs
    from repro_torch.core import predicate as pr
    from repro_torch.core.allowlist import Allowlist
    from repro_torch.tune import estimate_matches

    t = index.tuned
    mask = pr.evaluate(p, index.meta)
    matched = estimate_matches(p, index.meta, device=dev)
    mult = 1 if t.boost is None else t.boost.multiplier(matched / index.n_total)
    boosted = index.resolved_knobs(TUNE_K, **{knob: t.knobs[knob] * mult}) or {knob: 0}
    snap = obs.registry().snapshot()
    c.reset_counts()
    got = [index.search(c.queries[64 * i: 64 * (i + 1)], k=TUNE_K, where=p)
           for i in range(BATCHES)]
    torch.cuda.synchronize()
    launches = c.read_counts()
    applied = obs.counter_total(obs.counter_deltas(obs.registry().snapshot(), snap),
                                "engine.boost_applied")
    allow = Allowlist(mask=mask, n_allowed=int(mask.sum()))
    want = [index.search(c.queries[64 * i: 64 * (i + 1)], k=TUNE_K, allow=allow, **boosted)
            for i in range(BATCHES)]
    equal = all(same_result(a, b) for a, b in zip(got, want))
    cache = engine.plan_cache()
    tuned_s, boosted_s = index.searcher(k=TUNE_K), index.searcher(k=TUNE_K, where=p)
    tuned_s(c.queries[:64])
    boosted_s(c.queries[:64])
    before = cache.stats.snapshot()
    for i in range(BATCHES):
        tuned_s(c.queries[64 * i: 64 * (i + 1)])
        boosted_s(c.queries[64 * i: 64 * (i + 1)])
    after = cache.stats.since(before)
    out = {"share": float(mask.mean()), "matched": matched, "host_count": int(mask.sum()),
           "mult": mult, "boosted_knobs": boosted, "applied": applied, "oracle_equal": equal,
           "launches": launches, "captures_after_warmup": after.captures,
           "plans_after_warmup": after.misses}
    say(f"{label}: where= at {out['share']:.4%} of rows: estimate_matches {matched} = host "
        f"count {out['host_count']}; multiplier {mult} -> {boosted}, boost_applied {applied} "
        f"of {BATCHES} searches; ids and scores = the allowlist oracle's at the boosted knob "
        f"{equal}; 10 tuned + 10 boosted searches after a warm-up: captures {after.captures}, "
        f"new plans {after.misses}; launches {launches}")
    c.expect(matched == out["host_count"] and (mult > 1 or not must_boost)
             and applied == (BATCHES if mult > 1 else 0) and equal,
             f"{label}: the boost is not applied or not the oracle's")
    c.expect(after.captures == 0 and after.misses == 0,
             f"{label}: tuned or boosted searches captured after the warm-up")
    return out


def autotune_phase(c) -> dict:
    """Phase 9 (a, b, d): recall-targeted autotune through the engine's
    graphs: IVF at full width with the selectivity boost (9a), the sign
    cascade's rescore_mult ladder (9b), and the reference's autotune
    benchmark at its smoke shape, card against the CPU plain path (9d).
    9c (HNSW) runs inside phase 8 on its index (``hnsw_tune_phase``)."""
    torch, np, dev = c.torch, c.np, c.dev
    from repro_torch import MonaVec
    from repro_torch.core import rhdh
    from repro_torch.core.predicate import Eq, Lt
    from repro_torch.data.synthetic import embedding_corpus, queries_from_corpus

    corpus, expect = c.corpus, c.expect
    out: dict = {"launches": {}}
    tdir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    td = Path(tdir.name)
    one_pct = Eq("lang", "en") & Lt("date", 80_000)      # phase 7a's ~1% predicate
    cols = planted_columns(np, np.random.default_rng(SEED + 7))

    # ---- 9a. IVF at full width, with the boost ------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = MonaVec.build(corpus, meta=cols, index="ivf", nlist=IVF_NLIST,
                        train_iters=IVF_TRAIN_ITERS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sweep = tune_sweep(c, ivf, "9a ivf")
    out["launches"]["9a_sweep"] = sweep["launches"]
    got = sweep["launches"]
    expect(got["fwht"] > 0 and got["gather_nibble_dot"] > 0 and got["nibble_dot"] > 0,
           f"9a: the sweep did not run B2, B4 and the oracle's B1 ({got})")
    expect(sweep["ladder"][-1] == [IVF_NLIST, 1.0],
           f"9a: the ceiling rung nprobe={IVF_NLIST} is not exactly 1.0")
    out["ivf"] = {"build_s": build_s, "sweep": sweep,
                  "checks": tune_checks(c, ivf, sweep, td, "9a ivf")}
    out["ivf"]["boost"] = boost_checks(c, ivf, "nprobe", one_pct, "9a ivf boost",
                                       sweep["chosen"] < IVF_NLIST)
    # At 0.95 the stand-in needs every cell (nprobe = nlist, nothing left to
    # boost), so a sweep at a lower target drives the boost at this width.
    low = tune_sweep(c, ivf, "9a ivf, boost sweep", target=BOOST_TARGET)
    out["launches"]["9a_boost_sweep"] = low["launches"]
    out["ivf"]["boost_sweep"] = low
    out["ivf"]["boost_low"] = boost_checks(c, ivf, "nprobe", one_pct, "9a ivf boost at "
                                           f"{BOOST_TARGET}", True)
    out["launches"]["9a_boosted"] = out["ivf"]["boost_low"]["launches"]
    out["ivf"]["graphs_held"], out["ivf"]["graphs_mib"] = held_graph_mib(c, ivf)
    say(f"9a: the index's {out['ivf']['graphs_held']} graphs hold "
        f"{out['ivf']['graphs_mib']:.1f} MiB of reserved card memory")
    del ivf
    say(f"phase 9a: {time.perf_counter() - t_phase:.1f} s (build {build_s:.3f} s)")

    # ---- 9b. the sign cascade's rescore_mult ladder ---------------------------------
    t_phase = time.perf_counter()
    cas = MonaVec.build(corpus, meta=cols, coarse="sign")
    sweep = tune_sweep(c, cas, "9b sign cascade")
    out["launches"]["9b_sweep"] = sweep["launches"]
    got = sweep["launches"]
    last = sweep["ladder"][-1]
    expect(all(got[k] > 0 for k in ("fwht", "sign_hamming", "gather_nibble_dot", "nibble_dot")),
           f"9b: the sweep did not run B2, B6, B4 and B1 ({got})")
    expect(last[0] * TUNE_K >= N and last[1] == 1.0
           and cas.resolved_knobs(TUNE_K, rescore_mult=last[0]) == {},
           f"9b: the collapse rung {last} is not the full-scan plan at recall 1.0")
    out["cascade"] = {"sweep": sweep, "checks": tune_checks(c, cas, sweep, td, "9b sign")}
    out["cascade"]["boost"] = boost_checks(c, cas, "rescore_mult", one_pct, "9b sign boost",
                                           False)
    out["launches"]["9b_boosted"] = out["cascade"]["boost"]["launches"]
    out["cascade"]["graphs_held"], out["cascade"]["graphs_mib"] = held_graph_mib(c, cas)
    say(f"9b: the index's {out['cascade']['graphs_held']} graphs hold "
        f"{out['cascade']['graphs_mib']:.1f} MiB of reserved card memory")
    del cas
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 9b: {time.perf_counter() - t_phase:.1f} s")

    # ---- 9d. the reference's autotune benchmark, smoke shape ------------------------
    # benchmarks/autotune_bench.py:84-87 (n 8,192, d 64, 8 queries, nlist 64),
    # on the legacy threefry stream benchmarks/baselines/ was written on.
    t_phase = time.perf_counter()
    n_b, d_b, nlist_b, bq_n = 8192, 64, 64, 8
    b_corpus = embedding_corpus(97, n_b, d_b)
    attr = np.random.RandomState(97).randint(0, 100, size=n_b).astype(np.int64)
    bq = queries_from_corpus(b_corpus, 197, bq_n)
    stream = rhdh.THREEFRY_PARTITIONABLE
    rhdh.THREEFRY_PARTITIONABLE = False
    runs = {}
    try:
        for side, device in (("card", dev), ("cpu", "cpu")):
            idx = MonaVec.build(b_corpus, metric="cosine", index="ivf", nlist=nlist_b,
                                meta={"attr": attr}, device=device)
            c.reset_counts()
            t0 = time.perf_counter()
            idx.autotune(recall_target=TUNE_TARGET, k=TUNE_K)
            if side == "card":
                torch.cuda.synchronize()
            tune_s = time.perf_counter() - t0
            launches = c.read_counts()
            tuned = idx.tuned
            safe, tuned_s = idx.searcher(k=TUNE_K, nprobe=nlist_b), idx.searcher(k=TUNE_K)
            safe.warmup(bq_n)
            tuned_s.warmup(bq_n)
            rec = {"tuned": recall_at_10(tuned_s(bq)[1], safe(bq)[1])}
            where = Lt("attr", 1)
            gt_f = idx.searcher(k=TUNE_K, nprobe=nlist_b, where=where)(bq)[1]
            idx.tuned = dataclasses.replace(tuned, boost=None)
            rec["unboosted"] = recall_at_10(idx.searcher(k=TUNE_K, where=where)(bq)[1], gt_f)
            idx.tuned = tuned
            rec["boosted"] = recall_at_10(idx.searcher(k=TUNE_K, where=where)(bq)[1], gt_f)
            e = {"tuned": tuned, "tune_s": tune_s, "recall": rec, "launches": launches}
            if side == "card":
                for arm, fn in (("tuned", tuned_s), ("safe", safe)):
                    lat = []
                    for _ in range(20):
                        t0 = time.perf_counter()
                        fn(bq)
                        lat.append(time.perf_counter() - t0)
                    lat.sort()
                    e[f"{arm}_ms"] = {"median": 1e3 * lat[10], "p90": 1e3 * lat[17]}
            runs[side] = e
            del idx, safe, tuned_s
    finally:
        rhdh.THREEFRY_PARTITIONABLE = stream
    card, cpu = runs["card"], runs["cpu"]
    out["launches"]["9d_sweep"] = card["launches"]
    want = {"tuned": 0.9625, "unboosted": 0.55, "boosted": 1.0}
    tie = 1.0 / (bq_n * TUNE_K)
    t = card["tuned"]
    out["bench"] = {"knobs": t.knobs, "ladder": [[r.value, r.recall] for r in t.ladder["nprobe"]],
                    "boost": [[p.selectivity, p.mult, p.recall] for p in t.boost.points],
                    "tune_s_card": card["tune_s"], "tune_s_cpu": cpu["tune_s"],
                    "recall_card": card["recall"], "recall_cpu": cpu["recall"],
                    "tuned_equal_cpu": card["tuned"] == cpu["tuned"],
                    "tuned_ms": card["tuned_ms"], "safe_ms": card["safe_ms"], "gpu": c.smi}
    say(f"9d autotune_bench smoke (n {n_b}, d {d_b}, nlist {nlist_b}, {bq_n} queries, legacy "
        f"stream): tuned {t.knobs}, ladder {out['bench']['ladder']}, boost "
        f"{out['bench']['boost']}; recall@10 card {card['recall']} CPU plain {cpu['recall']} "
        f"(baseline {want}); TuneResult card = CPU {out['bench']['tuned_equal_cpu']}; tune "
        f"{card['tune_s']:.3f} s card, {cpu['tune_s']:.3f} s CPU; batch of {bq_n} on "
        f"{c.smi}: tuned median {card['tuned_ms']['median']:.4f} ms p90 "
        f"{card['tuned_ms']['p90']:.4f}, safe (nprobe {nlist_b}) median "
        f"{card['safe_ms']['median']:.4f} ms p90 {card['safe_ms']['p90']:.4f}; launches "
        f"{card['launches']}")
    expect(out["bench"]["tuned_equal_cpu"], "9d: the card's TuneResult is not the CPU's")
    expect(all(abs(card["recall"][k] - want[k]) <= tie + 1e-12
               and abs(cpu["recall"][k] - want[k]) <= tie + 1e-12 for k in want),
           "9d: a recall is not the baseline's within one id in 80")
    got = card["launches"]
    expect(got["fwht"] > 0 and got["gather_nibble_dot"] > 0 and got["nibble_dot"] > 0,
           f"9d: the card's sweep did not run B2, B4 and B1 ({got})")
    say(f"phase 9d: {time.perf_counter() - t_phase:.1f} s")
    tdir.cleanup()
    return out


def recall_at_10(pred_ids, gt_ids) -> float:
    """``benchmarks/common.recall_at_10`` (that module imports JAX)."""
    import numpy as np

    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt_ids.shape[1]
                          for a, b in zip(pred_ids.astype(np.int64), gt_ids.astype(np.int64))]))


def hnsw_tune_phase(c, h, sub, exact, recall, run) -> dict:
    """Phase 9c on phase 8a's index (Table 2's 8,192 rows): the ef ladder
    against the full scan over the same rows (no boost), the ef 1024 rung's
    beam iterations and device time, its recall@10 over the phase-4 queries
    against exact beside the full scan's (ROADMAP C3), and level-0
    reachability from the entry point (a host BFS over neighbors0)."""
    torch, np, dev = c.torch, c.np, c.dev
    from repro_torch.core import hnsw as hnsw_mod, quantize as qz
    from repro_torch.tune import sample_queries

    t_phase = time.perf_counter()
    sweep = tune_sweep(c, h, "9c hnsw")
    got = sweep["launches"]
    c.expect(got["fwht"] > 0 and got["gather_nibble_dot"] > 0 and got["nibble_dot"] > 0,
             f"9c: the sweep did not run B2, B4 and the oracle's B1 ({got})")
    c.expect(sweep["boost"] is None and [v for v, _ in sweep["ladder"]]
             == [10, 20, 40, 80, 160, 320, 640, 1024], "9c: not the reference's ef ladder")
    be = h.backend
    top = sweep["ladder"][-1][0]
    qs = torch.from_numpy(sample_queries(h, TUNE_QUERIES, h.tuned.seed)).to(dev)
    trace: list = []
    hnsw_mod.search_stage(qz.encode_query(qs, be.enc), be.enc.packed, be.enc.qnorms, be.nbr0_t,
                          be.nbr_hi_t, torch.ones(be.enc.n, dtype=torch.bool, device=dev),
                          entry=be.entry_point, ef=top, k=TUNE_K, metric="cosine", bits=4,
                          n4_dims=0, max_level=be.max_level, trace=trace)
    dev_ms, blocks = staged_device_ms(torch, h, {"ef": top}, c.queries)
    rec_top = recall(run(h, {"ef": top})[1], exact)
    nbr0 = be.neighbors0
    seen = np.zeros(be.enc.n, dtype=bool)
    seen[be.entry_point] = True
    frontier = np.array([be.entry_point])
    while frontier.size:
        nxt = nbr0[frontier].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    n_graphs, graphs_mib = held_graph_mib(c, h)
    out = {"sweep": sweep, "top_ef": top, "iterations": trace, "device_ms_64": dev_ms,
           "device_blocks_64": blocks, "recall_at_10_exact": rec_top,
           "reachable_level0": int(seen.sum()), "rows": int(be.enc.n),
           "graphs_held": n_graphs, "graphs_mib": graphs_mib}
    say(f"9c hnsw ef ladder recall vs the full scan over the {be.enc.n} rows "
        f"{sweep['ladder']}, met_target {sweep['met_target']}; ef={top}: iterations per loop "
        f"(descent levels, beam) for the {TUNE_QUERIES} sample queries {trace}; a search of 64 "
        f"{dev_ms:.4f} ms device (blocks {blocks}); recall@10 vs exact over the 640 queries "
        f"{rec_top:.4f}; level-0 reachability from entry {be.entry_point}: {int(seen.sum())} "
        f"of {be.enc.n} rows; the index's {n_graphs} graphs (8e's and the sweep's) held "
        f"{graphs_mib:.1f} MiB of reserved card memory")
    say(f"phase 9c: {time.perf_counter() - t_phase:.1f} s")
    return out


def sharded_device_ms(torch, sharded, kw: dict, qs, replays: int = 10) -> float:
    """``graph_device_ms`` for a ``ShardedMonaVec`` whose shards share one
    device: CUDA events around ``replays`` back-to-back replays of the one
    graph a search of 64 at k=10 with ``kw`` captures on a fresh handle of
    the same shards."""
    fresh = dataclasses.replace(sharded)       # the same shards, no graphs
    fresh.search(qs[:64], k=10, **kw)
    (graph,) = fresh.graphs.values()
    graph.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def serve_cli(argv: list) -> str:
    """``python -m repro_torch.launch.serve`` in this process: its output,
    echoed."""
    import io
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith("[trace]"):
            say(f"  {line}")
    return text


def split_mesh(mesh_cls, devices: tuple):
    """A mesh of ``devices`` whose shards form two device groups (the first
    half, the second), whatever the devices: the several-device plan on one
    card."""
    half = len(devices) // 2

    @dataclasses.dataclass(frozen=True)
    class SplitMesh(mesh_cls):
        @property
        def groups(self):
            return ((self.devices[0], tuple(range(half))),
                    (self.devices[half], tuple(range(half, len(self.devices)))))

    return SplitMesh(tuple(devices))


def shard_serve_phase(c) -> dict:
    """Phase 10: sharded retrieval through the engine's graphs (10a) and the
    serving CLI in-process (10b), after phase 9's indexes are dropped.
    ``c`` carries the main phase's tensors and helpers."""
    torch, np, dev = c.torch, c.np, c.dev
    import re
    from repro_torch import MonaVec, engine
    from repro_torch.core import scoring
    from repro_torch.core.predicate import Eq, Lt
    from repro_torch.core.segments import SENTINEL_ID
    from repro_torch.dist import ShardedMonaVec
    from repro_torch.launch.mesh import Mesh, make_local_mesh

    corpus, queries, expect = c.corpus, c.queries, c.expect
    out: dict = {"launches": {}}
    cache = engine.plan_cache()
    preds = {"lang_date": Eq("lang", "en") & Lt("date", 80_000),   # phase 7a's ~1%
             "eq_lang": Eq("lang", "en")}                          # and 12.5%
    full_kws = {"full": {}, **{name: {"where": p} for name, p in preds.items()}}

    def run(index, kw: dict, batches: int = BATCHES):
        res = [index.search(queries[64 * i: 64 * (i + 1)], k=10, **kw) for i in range(batches)]
        return np.concatenate([r[0] for r in res]), np.concatenate([r[1] for r in res])

    def warm_run(index, kw: dict):
        """One warm-up search (the capture), then ``run`` with its captures."""
        index.search(queries[:64], k=10, **kw)
        before = cache.stats.snapshot()
        got = run(index, kw)
        return got, cache.stats.since(before).captures

    qt = torch.from_numpy(queries).to(dev)
    exact = exact_topk(scoring.score_f32(qt, torch.from_numpy(corpus).to(dev), "cosine"),
                       10)[1].cpu().numpy()
    del qt

    # ---- 10a. sharded search -------------------------------------------------
    t_phase = time.perf_counter()
    idx = MonaVec.build(corpus, meta=planted_columns(np, np.random.default_rng(SEED + 7)),
                        coarse="sign")
    base = {name: run(idx, kw) for name, kw in full_kws.items()}
    base_cascade = {rm: run(idx, {"rescore_mult": rm}) for rm in RESCORE_MULTS}
    local = make_local_mesh()
    expect(local.size == 1 and local.devices == (dev,),
           f"10a: make_local_mesh() is {local.devices}, not the one card")
    meshes = {1: local, 4: Mesh.repeat(dev, 4), 7: Mesh.repeat(dev, 7)}
    sharded = {s: idx.shard(mesh) for s, mesh in meshes.items()}
    out["shards"] = {s: {"rows_per_shard": int(sh.shards[0].packed.shape[0]),
                         "padding_rows": int(sh.enc.n - N)} for s, sh in sharded.items()}
    c.reset_counts()
    torch.cuda.synchronize()
    full: dict = {}
    for s, sh in sharded.items():
        for name, kw in full_kws.items():
            got, captures = warm_run(sh, kw)
            real = got[1][got[1] != SENTINEL_ID]
            full[f"{s}_{name}"] = ok = {
                "equals_unsharded": same_result(got, base[name]),
                "no_padding_id": bool((real < N).all()), "captures_after_warmup": captures}
            expect(ok["equals_unsharded"], f"10a: {s} shard(s), {name}: not byte-equal to the "
                                           "unsharded graph replay")
            expect(ok["no_padding_id"], f"10a: {s} shard(s), {name}: a padding id surfaced")
            expect(captures == 0, f"10a: {s} shard(s), {name}: {captures} captures after "
                                  "the warm-up")
    torch.cuda.synchronize()
    out["launches"]["10a_full"] = got_l = c.read_counts()
    expect(got_l["fwht"] > 0 and got_l["nibble_dot"] > 0,
           f"10a: the sharded full scans did not run B2 and B1 ({got_l})")
    out["full"] = full
    say(f"10a: shards {out['shards']}; full / ~1% / 12.5% byte-equal to the unsharded replay, "
        f"no padding id, captures after warm-up: {full}; launches {got_l}")

    # The path of shards on several devices (``plan._MeshGraph``: a graph a
    # device, an event each, the candidates copied to the first device, the
    # merge's graph) on the one card: 4 shards in two groups of one device.
    split = idx.shard(split_mesh(Mesh, meshes[4].devices))
    split_ok = {}
    for name in ("full", "eq_lang"):
        got, captures = warm_run(split, full_kws[name])
        split_ok[name] = same_result(got, base[name]) and captures == 0
    kinds = sorted({type(g).__name__ for g in split.graphs.values()})
    out["two_groups"] = {"equals_unsharded": split_ok, "graphs": kinds}
    expect(all(split_ok.values()) and kinds == ["_MeshGraph"],
           f"10a: two device groups: {split_ok}, graphs {kinds}")
    say(f"10a: 4 shards in two device groups (the several-device graphs on one card): "
        f"byte-equal to the unsharded replay with 0 captures after warm-up {split_ok}; "
        f"graphs {kinds}")
    del split

    # The cascade: one shard keeps the unsharded survivors; four keep m each,
    # held against the port's plain path on the CPU over the same 4-shard mesh.
    enc = idx.backend.enc
    cpu4 = MonaVec.from_arrays(enc.packed.cpu().numpy(), enc.qnorms.cpu().numpy(),
                               seed=enc.seed, metric="cosine", bits=enc.bits, dim=DIM,
                               dim_pad=enc.dim_pad, device="cpu").enable_coarse("sign").shard(
        Mesh.repeat("cpu", 4))
    cpu_q = 64 * CPU_CASCADE_BATCHES
    cascade: dict = {}
    c.reset_counts()
    torch.cuda.synchronize()
    for rm in RESCORE_MULTS:
        one, cap1 = warm_run(sharded[1], {"rescore_mult": rm})
        four, cap4 = warm_run(sharded[4], {"rescore_mult": rm})
        cpu = run(cpu4, {"rescore_mult": rm}, CPU_CASCADE_BATCHES)
        ids_equal = float(np.mean(four[1][:cpu_q] == cpu[1]))
        cascade[rm] = ok = {
            "one_equals_unsharded": same_result(one, base_cascade[rm]),
            "four_ids_equal_cpu": ids_equal,
            "four_recall_at_10": recall_at_10(four[1], exact),
            "unsharded_recall_at_10": recall_at_10(base_cascade[rm][1], exact),
            "captures_after_warmup": cap1 + cap4}
        expect(ok["one_equals_unsharded"], f"10a: sign_{rm} on 1 shard differs from the "
                                           "unsharded cascade")
        expect(ids_equal >= 0.99, f"10a: sign_{rm} on 4 shards: ids {ids_equal:.4f} equal to "
                                  "the CPU plain path's (< 0.99)")
        expect(cap1 + cap4 == 0, f"10a: sign_{rm}: {cap1 + cap4} captures after the warm-up")
    collapse = {s: same_result(run(sharded[s], {"rescore_mult": N // 10}, 1),
                               run(sharded[s], {}, 1)) for s in (1, 4)}
    torch.cuda.synchronize()
    out["launches"]["10a_cascade"] = got_l = c.read_counts()
    expect(all(got_l[k] > 0 for k in ("fwht", "sign_hamming", "gather_nibble_dot")),
           f"10a: the sharded cascades did not run B2, B6 and B4 ({got_l})")
    expect(all(collapse.values()), f"10a: rescore_mult * k >= n is not the plain sharded "
                                   f"scan's bytes ({collapse})")
    out["cascade"], out["collapse_equals_full"] = cascade, collapse
    say(f"10a: sign cascades {cascade}; rm*k >= n = the plain scan {collapse}; "
        f"launches {got_l}")

    # Batch latency (host clock) and graph device time, unsharded and sharded.
    timing = {"unsharded": {**batch_latencies(lambda q: idx.search(q, k=10), queries,
                                              BATCHES),
                            "device_ms": graph_device_ms(torch, idx, {}, queries)}}
    for s, sh in sharded.items():
        timing[f"{s}_shards"] = {**batch_latencies(lambda q, sh=sh: sh.search(q, k=10),
                                                   queries, BATCHES),
                                 "device_ms": sharded_device_ms(torch, sh, {}, queries)}
    out["timing"] = timing
    for name, t in timing.items():
        say(f"10a timing {name}: batch median {t['median_ms']:.4f} ms, p90 {t['p90_ms']:.4f} "
            f"ms, graph device {t['device_ms']:.4f} ms ({c.smi})")
    # Where the device time goes: each plan's stages run eagerly on the card
    # under torch.profiler (a graph replay is never traced).
    from repro_torch.engine import plan as plan_mod
    profiles = {"unsharded": profile_window(torch, lambda: search_eager(idx, queries[:64]),
                                            "10a unsharded, eager stages")}
    on_card, plan_mod._on_card = plan_mod._on_card, (lambda d: False)
    try:
        for s in (4, 7):
            profiles[f"{s}_shards"] = profile_window(
                torch, lambda sh=sharded[s]: sh.search(queries[:64], k=10),
                f"10a {s} shards, eager stages")
    finally:
        plan_mod._on_card = on_card
    out["profiles"] = profiles

    # A v11 file of the tuned cascade index, loaded sharded: the tuned knob.
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        path = str(Path(tdir) / "tuned.mvec")
        idx.autotune(recall_target=TUNE_TARGET, k=TUNE_K, n_queries=TUNE_QUERIES)
        knob = idx.tuned.knobs.get("rescore_mult", 0)
        idx.save(path)
        loaded = ShardedMonaVec.load(path)
        tuned_ok = (loaded.tuned is not None and loaded.tuned.knobs == idx.tuned.knobs
                    and same_result(run(loaded, {}, 2),
                                    run(sharded[1], {"rescore_mult": knob}, 2)))
    out["tuned"] = {"knobs": dict(idx.tuned.knobs), "loaded_equals_explicit": tuned_ok}
    expect(tuned_ok, f"10a: the loaded v11 file does not search at its tuned knob {knob}")
    say(f"10a: v11 tuned knobs {idx.tuned.knobs} -> ShardedMonaVec.load searches as "
        f"rescore_mult={knob}: {tuned_ok}")
    del idx, sharded, loaded, cpu4
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 10a: {time.perf_counter() - t_phase:.1f} s")

    # ---- 10b. the serving CLI in-process ---------------------------------------------
    t_phase = time.perf_counter()
    shape = ["--n", str(N), "--dim", str(DIM)]
    cli: dict = {}
    texts: dict = {}
    c.reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tdir:
        td = Path(tdir)
        runs = {
            "lifecycle": shape + ["--filter-every", "8", "--mutate", "--compact",
                                  "--micro-batch", "8", "--trace-sample", "5",
                                  "--metrics-json", str(td / "p.json"),
                                  "--metrics-prom", str(td / "q.prom"),
                                  "--save", str(td / "f.mvec")],
            "shard": shape + ["--shard", "--filter-every", "8", "--coarse", "sign",
                              "--rescore-mult", "8", "--metrics-json", str(td / "s.json")],
            "ivf": shape + ["--index", "ivf", "--autotune", "--recall-target", "0.95",
                            "--save", str(td / "g.mvec")],
            "ivf_load": ["--load", str(td / "g.mvec")]}
        for name, argv in runs.items():
            say(f"10b: serve {' '.join(argv)}")
            t0 = time.perf_counter()
            text = serve_cli(argv)
            phases = re.findall(r"\[serve\] (\w+): (\d+) queries in ([\d.]+)s -> (\d+) QPS",
                                text)
            windows = re.findall(r"\[serve\] (\w+): plan cache hits=(\d+) misses=(\d+) "
                                 r"captures=(\d+)", text)
            clean = bool(windows) and len(windows) == len(phases) and all(
                m == "0" and cap == "0" for _, _, m, cap in windows)
            texts[name] = text
            cli[name] = {"seconds": time.perf_counter() - t0,
                         "qps": {p: int(q) for p, _, _, q in phases}, "clean_windows": clean}
            expect(clean, f"10b {name}: a measured window has a miss or a capture ({windows})")
        snap = json.loads((td / "p.json").read_text())["histograms"]
        expect(any(k.startswith("engine.stage_us{") for k in snap),
               "10b lifecycle: the metrics JSON holds no engine.stage_us")
        expect("plan_cache_hits" in (td / "q.prom").read_text(),
               "10b lifecycle: the Prometheus text holds no plan_cache_hits")
        snap = json.loads((td / "s.json").read_text())["histograms"]
        expect(any(k.startswith("engine.stage_us{") for k in snap)
               and any(k.startswith("dist.search_us{") for k in snap),
               "10b shard: the metrics JSON holds no engine.stage_us or dist.search_us")
        tuned = MonaVec.load(str(td / "g.mvec")).tuned
        reload_ok = tuned is not None and cli["ivf_load"]["clean_windows"] and (
            f"[serve] static: knobs={tuned.knobs} (tuned)" in texts["ivf_load"])
        cli["ivf_load"]["tuned_knobs"] = None if tuned is None else dict(tuned.knobs)
        expect(reload_ok, "10b: the reload does not serve at the tuned knobs")
    torch.cuda.synchronize()
    out["launches"]["10b_cli"] = got_l = c.read_counts()
    expect(all(got_l[k] > 0 for k in ("fwht", "nibble_dot", "sign_hamming",
                                        "gather_nibble_dot")),
           f"10b: the CLI runs did not run B2, B1, B6 and B4 ({got_l})")
    out["cli"] = cli
    for name, r in cli.items():
        say(f"10b {name}: {r['seconds']:.1f} s, QPS by phase {r['qps']} ({c.smi}), "
            f"windows clean {r['clean_windows']}")
    say(f"10b: launches {got_l}")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 10b: {time.perf_counter() - t_phase:.1f} s")
    return out


def kernel_counters() -> dict:
    """B1-B7's and the top-k select's launch counters by the names of the
    kernels line."""
    from repro_torch.kernels import binary_dot, gather_dot, hadamard, nibble_dot, topk_select

    return {"fwht": hadamard.fwht_cuda, "nibble_dot": nibble_dot.nibble_dot_cuda,
            "sign_hamming": binary_dot.sign_hamming_cuda,
            "crumb_affinity": binary_dot.crumb_affinity_cuda,
            "gather_nibble_dot": gather_dot.gather_nibble_dot_cuda,
            "crumb_dot": nibble_dot.crumb_dot_cuda,
            "gather_crumb_dot": gather_dot.gather_crumb_dot_cuda,
            "topk_select": topk_select.topk_select_cuda}


def reset_launches(counters: dict) -> None:
    for counter in counters.values():
        counter.launches = 0


def read_launches(counters: dict) -> dict:
    return {name: counter.launches for name, counter in counters.items()}


@contextlib.contextmanager
def launches_into(out: dict, part: str, counters: dict):
    """Set every counter to 0, run the body, store the counts under ``part``."""
    reset_launches(counters)
    try:
        yield
    finally:
        out[part] = read_launches(counters)


def probe_docs(np, n: int, n_queries: int):
    """11b's hybrid docs (seeded words a row and the row's topic term) and
    each query's text (the first words of a random row's doc)."""
    rng = np.random.default_rng(SEED + 13)
    words = np.array(HYBRID_WORDS)
    docs = [" ".join([f"term{r % 61}"] + list(words[rng.integers(0, len(words),
                                                                 rng.integers(2, 7))]))
            for r in range(n)]
    texts = [" ".join(docs[r].split()[:3]) for r in rng.integers(0, n, size=n_queries)]
    return docs, texts


def audit_phase(torch, say, counters) -> dict:
    """11a, in the child: the audit on the card and on the CPU, and the
    hazard self-test through the CLI's entry point."""
    import io

    from repro_torch.analysis import audit

    out: dict = {}
    t0 = time.perf_counter()
    with launches_into(out, "launches", counters):
        card = audit.run_audit(device="cuda")
    out["cuda_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = audit.run_audit(device="cpu")
    out["cpu_s"] = time.perf_counter() - t0
    for name, rep in (("cuda", card), ("cpu", cpu)):
        out[name] = {k: rep[k] for k in ("ok", "counts", "captures", "grid_points",
                                         "launches", "rerun_launches", "environment")}
        out[name]["active"] = [f for f in rep["findings"] if not f["allowlisted"]]
        out[name]["stale"] = rep["stale_allowlist_entries"]
    say(f"11a: audit on the card {out['cuda_s']:.1f} s: {card['captures']} captures "
        f"(CPU run: {cpu['captures']} in {out['cpu_s']:.1f} s), counts {card['counts']} "
        f"(CPU {cpu['counts']}), {card['grid_points']} grid points")
    say(f"11a: kernel launches over the grid's searches {card['launches']}, over the "
        f"audited stage reruns {card['rerun_launches']}")
    for f in out["cuda"]["active"] + out["cpu"]["active"]:
        say(f"11a: ACTIVE {f['check']} {f['site']}: {f['detail']}")
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as td, contextlib.redirect_stdout(buf):
        rc = audit.main(["--device", "cuda", "--inject-hazard", "--quiet",
                         "--report", str(Path(td) / "hazard.json")])
    text = buf.getvalue()
    out["hazard"] = {"rc": rc, "const_array": "const-array" in text,
                     "full_scan_dot": "full-scan-dot" in text}
    say(f"11a: --inject-hazard exit {rc}, names const-array "
        f"{out['hazard']['const_array']}, full-scan-dot {out['hazard']['full_scan_dot']}")
    return out


def probe_phase(torch, np, dev, say, counters) -> dict:
    """11b, in the child: every path at full width searched twice and
    through its eager stages with the deterministic flag off, then on
    indexes built under it; two builds under the flag saved twice."""
    from repro_torch import MonaVec
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.predicate import Eq, Lt
    from repro_torch.data.synthetic import embedding_corpus, queries_from_corpus
    from repro_torch.launch.mesh import Mesh

    corpus = embedding_corpus(SEED, N, DIM)
    q = queries_from_corpus(corpus, SEED + 1, 64 * BATCHES)[:PROBE_QUERIES]
    cols = filter_columns(np, np.random.default_rng(SEED + 7), N)
    docs, texts = probe_docs(np, N, PROBE_QUERIES)
    one_pct = Eq("lang", "en") & Lt("date", 80_000)          # phase 7a's ~1%

    makers = {"bf": lambda: MonaVec.build(corpus, meta=cols, coarse="sign"),
                "crumb": lambda: MonaVec.build(corpus, coarse="crumb"),
                "b2": lambda: MonaVec.build(corpus, bits=2),
                "ivf": lambda: MonaVec.build(corpus, index="ivf", nlist=IVF_NLIST,
                                             train_iters=IVF_TRAIN_ITERS),
                "hnsw": lambda: MonaVec.build(corpus[:HNSW_SMALL], index="hnsw"),
                "hybrid": lambda: HybridIndex.build(corpus, docs)}

    def build(keys=tuple(makers)) -> dict:
        return {key: makers[key]() for key in keys}

    paths = {"full4": ("bf", {}), "sign_32": ("bf", {"rescore_mult": 32}),
             "crumb_32": ("crumb", {"rescore_mult": 32}), "full2": ("b2", {}),
             "ivf_16": ("ivf", {"nprobe": 16}), "where_1pct": ("bf", {"where": one_pct}),
             "shard4": ("bf", {}), "hnsw_64": ("hnsw", {"ef": 64}), "hybrid": ("hybrid", {})}

    def run_paths(idx: dict) -> dict:
        got = {}
        for name, (key, kw) in paths.items():
            index = idx[key]
            if name == "hybrid":
                got[name] = [index.search(q, texts, k=10) for _ in range(2)]
                continue
            if name == "shard4":
                index = index.shard(Mesh.repeat(dev, 4))
            runs = [index.search(q, k=10, **kw) for _ in range(2)]    # capture, replay
            if name != "shard4":
                runs.append(search_eager(index, q, **kw))
            got[name] = runs
        return got

    def files(idx: dict, td: str, tag: str) -> dict:
        out = {}
        for key in ("bf", "ivf"):
            path = Path(td) / f"{tag}_{key}.mvec"
            idx[key].save(str(path))
            out[key] = hashlib.sha256(path.read_bytes()).hexdigest()
        return out

    out: dict = {}
    t0 = time.perf_counter()
    with launches_into(out, "launches", counters), tempfile.TemporaryDirectory() as td:
        torch.use_deterministic_algorithms(False)
        idx = build()
        results = run_paths(idx)
        hashes = {"off": files(idx, td, "off")}
        del idx
        torch.cuda.empty_cache()
        try:
            torch.use_deterministic_algorithms(True)
            fill = torch.utils.deterministic.fill_uninitialized_memory
            for tag in ("on1", "on2"):      # the second build: the saved files only
                idx = build() if tag == "on1" else build(("bf", "ivf"))
                hashes[tag] = files(idx, td, tag)
                if tag == "on1":
                    for name, runs in run_paths(idx).items():
                        results[name] += runs
                del idx
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
    out["seconds"] = time.perf_counter() - t0
    out["fill_uninitialized_memory"] = bool(fill)
    out["paths"] = {}
    for name, runs in results.items():
        want = results["full4"][0] if name == "shard4" else runs[0]
        same = [same_result(r, want) for r in runs]
        out["paths"][name] = same
        say(f"11b {name}: {len(runs)} results (flag off: 2 searches"
            f"{' + eager' if name not in ('shard4', 'hybrid') else ''}, then on), "
            f"byte-identical {same}")
    out["files"] = hashes
    say(f"11b: files (sha256) off {hashes['off']}, on {hashes['on1']}, again {hashes['on2']}; "
        f"fill_uninitialized_memory {bool(fill)}; {out['seconds']:.1f} s")
    return out


def determinism_child(report_path: str) -> int:
    """Phase 11's child: 11a and 11b on the card, the report written to
    ``report_path``; non-zero when the card is missing or a phase raised."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 11: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    counters = kernel_counters()
    report = {"env": {k: os.environ.get(k) for k in PHASE11_ENV}}
    t0 = time.perf_counter()
    report["audit"] = audit_phase(torch, say, counters)
    report["audit"]["seconds"] = time.perf_counter() - t0
    say(f"phase 11a: {report['audit']['seconds']:.1f} s")
    t0 = time.perf_counter()
    report["probe"] = probe_phase(torch, np, dev, say, counters)
    say(f"phase 11b: {time.perf_counter() - t0:.1f} s")
    Path(report_path).write_text(json.dumps(report))
    return 0


def run_child(flag: str, env: dict, timeout_s: int, label: str, expect) -> Optional[dict]:
    """Run this script with ``flag PATH`` in a child process with ``env``
    added, relay its output, and return the report it wrote to PATH (None if
    it wrote none).  A child's exit code other than 0 fails ``label`` unless
    its report lists the failed checks (the caller relays those)."""
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "report.json"
        try:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag,
                                   str(path)], capture_output=True, text=True,
                                  env=dict(os.environ, **env), cwd=str(ROOT), timeout=timeout_s)
        except subprocess.TimeoutExpired as exc:
            expect(False, f"{label}: the child ran past {timeout_s} s")
            out = exc.stdout or b""
            say(out.decode(errors="replace") if isinstance(out, bytes) else out)
            return None
        for line in proc.stdout.splitlines():
            say(f"  {line}")
        report = json.loads(path.read_text()) if path.exists() else None
    if report is None or not report.get("failures"):
        expect(proc.returncode == 0,
               f"{label}: the child exited {proc.returncode}: {proc.stderr[-4000:]}")
    return report


def determinism_phase(c) -> dict:
    """Phase 11: run ``determinism_child`` in a child process with
    ``PHASE11_ENV`` added, relay its output and check its report."""
    report = run_child("--phase11-child", PHASE11_ENV, PHASE11_TIMEOUT_S, "phase 11", c.expect)
    if report is None:
        return {"launches": {}}
    return check_determinism(report, c.expect)


def check_determinism(report: dict, expect) -> dict:
    """Phase 11's checks on the child's report; adds its launches by part."""
    a, p = report["audit"], report["probe"]
    expect(report["env"] == PHASE11_ENV, f"11: the child's environment {report['env']}")
    for dev_name in ("cuda", "cpu"):
        r = a[dev_name]
        expect(r["ok"] and r["counts"]["active"] == 0 and not r["stale"],
               f"11a: the {dev_name} audit: {r['counts']}, stale {r['stale']}")
    expect(all(n > 0 for n in a["cuda"]["launches"].values()),
           f"11a: a kernel was never launched over the grid: {a['cuda']['launches']}")
    expect(a["hazard"]["rc"] != 0 and a["hazard"]["const_array"]
           and a["hazard"]["full_scan_dot"],
           f"11a: --inject-hazard did not fail naming both hazards: {a['hazard']}")
    for name, same in p["paths"].items():
        expect(all(same), f"11b {name}: a result differs {same}")
    files = p["files"]
    expect(files["on1"] == files["on2"],
           f"11b: two builds under the flag wrote different files {files}")
    expect(files["off"] == files["on1"],
           f"11b: a build under the flag wrote another file than one without {files}")
    report["launches"] = {"11a": a["launches"], "11b": p["launches"]}
    return report


# ---------------------------------------------------------------------------
# Phase 12: the model zoo's serving forwards on the card (child process).
# ---------------------------------------------------------------------------

def bytes_equal(torch, a, b) -> bool:
    """Equal shapes, dtypes and bytes (+0.0 and -0.0 differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        b = b.view(a.dtype)
    return bool(torch.equal(a, b))


def model_copy(model, device):
    """The same parameters (and class) on ``device``."""
    twin = type(model)(model.cfg, device="meta")
    twin.load_state_dict({k: v.to(device, copy=True) for k, v in model.state_dict().items()},
                         strict=True, assign=True)
    return twin


def pad_cache(torch, caches: list, max_len: int) -> list:
    """Prefill caches ([L, B, S, ...]) grown to ``max_len`` positions (zeros)."""
    out = []
    for block in caches:
        grown = {}
        for name, t in block.items():
            g = t.new_zeros(t.shape[:2] + (max_len,) + t.shape[3:])
            g[:, :, :t.shape[2]] = t
            grown[name] = g
        out.append(grown)
    return out


def logit_gap(torch, got, want) -> dict:
    """Max |diff|, whether within the f32 tolerance, argmax agreement."""
    diff = (got.float() - want.float()).abs()
    return {"max_abs": float(diff.max()),
            "within_f32_tol": bool((diff <= ZOO_F32_ATOL + ZOO_F32_RTOL
                                    * want.float().abs()).all()),
            "argmax": float((got.argmax(-1) == want.argmax(-1)).float().mean())}


def cache_bytes(caches: list) -> int:
    return sum(t.numel() * t.element_size() for block in caches for t in block.values())


def decode_run(torch, tf, model, cfg, tokens, steps: int, *, batch: int, max_len: int,
               quantized: bool, dev, cache=None, start: int = 0, each=None):
    """``steps`` decode steps of ``tokens[:, start + t]`` from ``cache`` (an
    empty one when None); returns (logits of every step [B, steps, V], cache,
    seconds).  ``each(t)`` is entered around step t when given."""
    if cache is None:
        cache = tf.init_decode_cache(cfg, batch, max_len, quantized=quantized, device=dev)
    logits = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        with (each(t) if each else contextlib.nullcontext()):
            lg, cache = tf.decode_step(model, cfg, cache, tokens[:, start + t:start + t + 1],
                                       start + t, quantized=quantized)
        logits.append(lg)
    torch.cuda.synchronize()
    return torch.stack(logits, dim=1), cache, time.perf_counter() - t0


def routing_replay(torch, tf, model, cfg, f32_model, f32_cfg, toks) -> dict:
    """An MoE model's forward against the f32 forward: the (token, layer)
    pairs whose top-k experts differ, and the max |logit diff| with the f32
    forward's routing replayed in place of the model's own."""
    from repro_torch.models import moe

    route, seen, replay = moe.route, [], []

    def recording(x, p, mcfg):
        seen.append(replay.pop(0) if replay else route(x, p, mcfg))
        return seen[-1]

    moe.route = recording
    try:
        want = tf.forward(f32_model, f32_cfg, toks)[0]
        f32_routes, seen = seen, []
        tf.forward(model, cfg, toks)
        flips = sum(int((a[0] != b[0]).any(-1).sum()) for a, b in zip(f32_routes, seen))
        replay.extend(f32_routes)
        replayed = tf.forward(model, cfg, toks)[0]
    finally:
        moe.route = route
    return {"flips": flips, "pairs": sum(int(r[0].shape[0]) for r in f32_routes),
            "replayed_distance": float((replayed.float() - want).abs().max())}


def decode_parity(torch, tf, model, cfg, toks, s0: int, dev) -> dict:
    """prefill(toks[:, :s0]) then decode toks[:, s0:] against forward(toks):
    in the model's dtype (forward and decode twice, byte-identical), and in
    f32 on an f32 copy of the same weights.  The f32 gaps must be within the
    reference's test tolerance; in a lower precision the forward's, the
    prefill's and the decode's max |diff| from the f32 forward each within
    ``ZOO_BF16_LIMIT`` (``ZOO_BF16_MOE_LIMIT`` for an MoE model, whose
    forward with the f32 routing replayed is held to ``ZOO_BF16_LIMIT``)."""
    b, s = toks.shape
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_model = type(model)(f32_cfg, device="meta")
    f32_model.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                              strict=True, assign=True)
    out, logits = {}, {}
    for name, m, c in (("model", model, cfg), ("f32", f32_model, f32_cfg)):
        fwd = tf.forward(m, c, toks)[0][:, s0 - 1:]
        last, caches = tf.prefill(m, c, toks[:, :s0], last_only=True)
        runs = [decode_run(torch, tf, m, c, toks, s - s0, batch=b, max_len=s, quantized=False,
                           dev=dev, cache=pad_cache(torch, caches, s), start=s0)[0]
                for _ in range(2 if name == "model" else 1)]
        out[name] = {"prefill_gap": logit_gap(torch, last, fwd[:, 0]),
                     "decode_gap": logit_gap(torch, runs[0], fwd[:, 1:])}
        if name == "model":
            out["deterministic"] = (bytes_equal(torch, runs[0], runs[1]) and bytes_equal(
                torch, fwd, tf.forward(m, c, toks)[0][:, s0 - 1:]))
        logits[name] = {"forward": fwd.float(), "prefill": last.float(),
                        "decode": runs[0].float()}
        del caches, runs, last, fwd
    want = logits["f32"]["forward"]
    got = logits["model"]
    out["f32_distance"] = {
        "forward": float((got["forward"] - want).abs().max()),
        "prefill": float((got["prefill"] - want[:, 0]).abs().max()),
        "decode": float((got["decode"] - want[:, 1:]).abs().max())}
    out["limit"] = ZOO_BF16_MOE_LIMIT if cfg.moe else ZOO_BF16_LIMIT
    del logits
    out["routing"] = (routing_replay(torch, tf, model, cfg, f32_model, f32_cfg, toks)
                      if cfg.moe else None)
    out["ok"] = (out["f32"]["prefill_gap"]["within_f32_tol"]
                 and out["f32"]["decode_gap"]["within_f32_tol"]
                 and (cfg.dtype == "float32"
                      or (max(out["f32_distance"].values()) <= out["limit"]
                          and (out["routing"] is None or out["routing"]["replayed_distance"]
                               <= ZOO_BF16_LIMIT))))
    del f32_model
    return out


def parity_line(res: dict) -> str:
    m, f, e = res["model"], res["f32"], res["f32_distance"]
    return (f"prefill vs forward max |diff| {m['prefill_gap']['max_abs']:.4g}, decode "
            f"{m['decode_gap']['max_abs']:.4g} (argmax agreement {m['decode_gap']['argmax']:.4f}); "
            f"from the f32 forward: forward {e['forward']:.4g}, prefill {e['prefill']:.4g}, "
            f"decode {e['decode']:.4g} (limit {res['limit']}); "
            + (f"routing: {res['routing']['flips']} of {res['routing']['pairs']} (token, layer) "
               f"pairs take other experts than in f32, with the f32 routing replayed the "
               f"forward is {res['routing']['replayed_distance']:.4g} from f32 (limit "
               f"{ZOO_BF16_LIMIT}); " if res["routing"] else "") +
            f"in f32: prefill {f['prefill_gap']['max_abs']:.3g}, decode "
            f"{f['decode_gap']['max_abs']:.3g} (rtol {ZOO_F32_RTOL}, atol {ZOO_F32_ATOL} held "
            f"{f['prefill_gap']['within_f32_tol'] and f['decode_gap']['within_f32_tol']}); "
            f"forward and decode twice byte-identical {res['deterministic']}")


def llama_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """12a: llama3.2-3b at full width: prefill + decode against the forward,
    then the bf16 and the 4-bit cache side by side from an empty cache."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import hadamard
    from repro_torch.models import kvcache, transformer as tf

    out: dict = {}
    cfg = z.full_config(z.llama)
    t0 = time.perf_counter()
    model = tf.Transformer(cfg, torch.Generator(dev).manual_seed(z.seed), dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    report_line(f"12a {cfg.name}: {out['params']:,} parameters ({cfg.dtype}) initialised "
                f"on the card in {out['init_s']:.2f} s")

    # Prefill + decode against the forward of the same tokens.
    b, s0 = z.lm_prefill
    toks = torch.tensor(lm_batch(z.seed, 0, b, s0 + z.lm_decode, cfg.vocab)["tokens"],
                        device=dev)
    with launches_into(launches, "12a_prefill_decode", counters):
        out["parity"] = decode_parity(torch, tf, model, cfg, toks, s0, dev)
    report_line(f"12a prefill {b} x {s0} + {z.lm_decode} decode steps vs forward of "
                f"{s0 + z.lm_decode} tokens: {parity_line(out['parity'])}")
    expect(out["parity"]["ok"], f"12a: {cfg.name} prefill / decode vs forward: {out['parity']}")
    expect(out["parity"]["deterministic"], "12a: two bf16 forward / decode runs differ")
    gc.collect()
    torch.cuda.empty_cache()

    # The bf16 and the 4-bit cache from empty, on the same tokens.
    qb, qlen, steps = z.q_batch, z.q_max_len, z.q_steps
    qt = torch.tensor(lm_batch(z.seed, 1, qb, steps, cfg.vocab)["tokens"], device=dev)
    per = {}
    for name, quantized in (("bf16", False), ("4bit", True)):
        with launches_into(launches, f"12a_{name}", counters):
            lg, cache, secs = decode_run(torch, tf, model, cfg, qt, steps, batch=qb,
                                         max_len=qlen, quantized=quantized, dev=dev)
        per[name] = {"logits": lg, "seconds": secs, "tokens_per_s": qb * steps / secs,
                     "cache_bytes": cache_bytes(cache),
                     "bytes_per_token_layer": cache_bytes(cache) // (qb * qlen * cfg.n_layers)}
        report_line(f"12a {name} cache: {steps} decode steps of batch {qb} (max_len {qlen}) "
                    f"in {secs:.3f} s = {per[name]['tokens_per_s']:.1f} tokens/s; cache "
                    f"{per[name]['cache_bytes']:,} B ({per[name]['bytes_per_token_layer']} B a "
                    f"token and layer)")
        # One step traced (the last position again: it rewrites the same row).
        prof = profile_window(torch, lambda: tf.decode_step(
            model, cfg, cache, qt[:, steps - 1:steps], steps - 1, quantized=quantized),
            f"12a {name} decode step", top=6)
        per[name]["profile"] = prof
        report_line(f"12a {name} decode step traced: wall {prof['wall_us']:.0f} us, device "
                    f"busy {prof['device_busy_us']:.0f} us, idle share {prof['idle_share']:.3f}, "
                    f"{prof['kernels']} device activities")
        del cache
    b2 = launches["12a_4bit"]["fwht"]
    out["b2_per_step"] = b2 / steps
    expect(b2 == 4 * cfg.n_layers * steps and launches["12a_bf16"]["fwht"] == 0,
           f"12a: B2 launched {b2} times over {steps} 4-bit steps, not "
           f"{4 * cfg.n_layers} a step (bf16 cache: {launches['12a_bf16']['fwht']})")
    lf, lq = per["bf16"]["logits"][:, -1], per["4bit"]["logits"][:, -1]
    out["agree"] = float((lf.argmax(-1) == lq.argmax(-1)).float().mean())
    out["max_diff"] = float((lf - lq).abs().max())
    out["agree_all_steps"] = float((per["bf16"]["logits"].argmax(-1)
                                    == per["4bit"]["logits"].argmax(-1)).float().mean())
    report_line(f"12a 4-bit vs bf16 cache at step {steps}: argmax agreement {out['agree']:.4f} "
                f"(all steps {out['agree_all_steps']:.4f}; the reference's smoke bound >= 0.5), "
                f"max |logit diff| {out['max_diff']:.4f} (smoke bound < 2.0); B2 "
                f"{out['b2_per_step']:.0f} launches a step")

    # A second 4-bit run: byte-identical, and at one step every B2 output in
    # _rotate / _unrotate held against the butterfly, every code against the
    # CPU plain path's for the same k / v.
    recorded = {"fwht": [], "kv": []}
    fwht_fn, quant_fn = hadamard.signed_fwht, tf.quantize_kv

    def record_fwht(x, signs, d_pad):
        y = fwht_fn(x, signs, d_pad)
        recorded["fwht"].append((x.clone(), signs, d_pad, y.clone()))
        return y

    def record_kv(x, spec):
        codes, scale = quant_fn(x, spec)
        recorded["kv"].append((x.clone(), spec, codes.clone(), scale.clone()))
        return codes, scale

    @contextlib.contextmanager
    def each(t):
        if t != z.record_step:
            yield
            return
        hadamard.signed_fwht, tf.quantize_kv = record_fwht, record_kv
        try:
            yield
        finally:
            hadamard.signed_fwht, tf.quantize_kv = fwht_fn, quant_fn

    lg2, cache2, _ = decode_run(torch, tf, model, cfg, qt, steps, batch=qb, max_len=qlen,
                                quantized=True, dev=dev, each=each)
    lg3, cache3, _ = decode_run(torch, tf, model, cfg, qt, steps, batch=qb, max_len=qlen,
                                quantized=True, dev=dev)
    out["4bit_deterministic"] = (bytes_equal(torch, lg2, per["4bit"]["logits"])
                                 and bytes_equal(torch, lg3, lg2)
                                 and all(bytes_equal(torch, cache2[i][n], cache3[i][n])
                                         for i in range(len(cache2)) for n in cache2[i]))
    lf2, _, secs = decode_run(torch, tf, model, cfg, qt, steps, batch=qb, max_len=qlen,
                              quantized=False, dev=dev)
    per["bf16"]["tokens_per_s_second_run"] = qb * steps / secs
    out["bf16_deterministic"] = bytes_equal(torch, lf2, per["bf16"]["logits"])
    del cache2, cache3, lg2, lg3, lf2
    same = [bytes_equal(torch, y, hadamard.signed_fwht_butterfly(x, s, d))
            for x, s, d, y in recorded["fwht"]]
    out["fwht_recorded"] = len(same)
    out["fwht_byte_equal"] = sum(same)
    flips = levels = n_codes = 0
    scale_rel = 0.0
    for x, spec, codes, scale in recorded["kv"]:
        c_cpu, s_cpu = kvcache.quantize_kv(x.cpu(), spec)
        got = kvcache.unpack_4bit(codes.cpu()).long()
        want = kvcache.unpack_4bit(c_cpu).long()
        flips += int((got != want).sum())
        levels = max(levels, int((got - want).abs().max()))
        n_codes += got.numel()
        scale_rel = max(scale_rel, float(((scale.cpu() - s_cpu).abs()
                                          / s_cpu.clamp(min=1e-30)).max()))
    out["codes"] = {"n": n_codes, "flips": flips, "max_levels": levels,
                    "scale_max_rel": scale_rel, "calls": len(recorded["kv"])}
    report_line(f"12a step {z.record_step}: {out['fwht_byte_equal']} of {out['fwht_recorded']} "
                f"B2 outputs in _rotate / _unrotate byte-equal to signed_fwht_butterfly; "
                f"codes of {len(recorded['kv'])} quantize_kv calls ({n_codes:,} codes) against "
                f"the CPU plain path: {flips} one-level flips, max {levels} level(s), scales "
                f"within rel {scale_rel:.2e}; second / third 4-bit runs byte-identical "
                f"{out['4bit_deterministic']}, second bf16 run {out['bf16_deterministic']}")
    expect(out["fwht_recorded"] == 4 * cfg.n_layers and all(same),
           f"12a: B2 in the 4-bit cache: {out['fwht_byte_equal']} of {out['fwht_recorded']} "
           f"byte-equal to the butterfly ({4 * cfg.n_layers} expected)")
    expect(levels <= 1 and flips <= max(1, n_codes // 1000),
           f"12a: the card's cache codes against the CPU plain path's: {out['codes']}")
    expect(out["4bit_deterministic"] and out["bf16_deterministic"],
           "12a: two full-width decode runs differ")
    out["caches"] = {name: {k: v for k, v in per[name].items() if k != "logits"}
                     for name in per}
    del model, per
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_tower_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """12b: the two-tower retrieval cell at full width: the 1M-item corpus
    encoded (B2), users retrieved through B2 then B1, against the CPU plain
    path over the same codes and the exact f32 scores."""
    from repro_torch.models import recsys as rs

    out: dict = {}
    cfg = z.full_config("two-tower-retrieval")
    t0 = time.perf_counter()
    model = rs.TwoTower(cfg, torch.Generator(dev).manual_seed(z.seed), dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out.update(two_tower_serve(torch, np, dev, z, model, cfg, "12b", expect, report_line,
                               counters, launches))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_tower_serve(torch, np, dev, z, model, cfg, part: str, expect, report_line, counters,
                    launches) -> dict:
    """``part`` (12b, 13c): ``retrieval_cand``'s items embedded by ``model``'s
    towers and encoded (B2), users retrieved through B2 then B1, against the
    CPU plain path over the same codes and the exact f32 scores."""
    from repro_torch.core import quantize as qz
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.dist.steps import two_tower_retrieve
    from repro_torch.models import recsys as rs

    out: dict = {}
    enc_n, ret_n = f"{part}_encode", f"{part}_retrieve"
    with launches_into(launches, enc_n, counters):
        t0 = time.perf_counter()
        items = rs.item_embedding(model, cfg, torch.arange(z.tt_items, device=dev))
        enc = qz.encode(items, metric="cosine")
        torch.cuda.synchronize()
        out["encode_s"] = time.perf_counter() - t0
    hist = torch.tensor(recsys_batch(z.seed, 0, "two-tower-retrieval", cfg,
                                     z.tt_users)["user_hist"], device=dev)
    report_line(f"{part} {cfg.name}: tables {2 * cfg.user_vocab * cfg.embed_dim * 4:,} B; "
                f"{z.tt_items:,} items embedded and encoded in {out['encode_s']:.3f} s: "
                f"{enc.packed.numel():,} B of 4-bit codes (d' {enc.dim_pad})")
    with launches_into(launches, ret_n, counters):
        one = two_tower_retrieve(model, cfg, hist[:1], enc.packed, enc.qnorms, k=10)
        many = two_tower_retrieve(model, cfg, hist, enc.packed, enc.qnorms, k=10)
    expect(launches[ret_n]["fwht"] == 2 and launches[ret_n]["nibble_dot"] == 2
           and launches[enc_n]["fwht"] >= 1,
           f"{part}: B2 / B1 launches {launches[enc_n]} {launches[ret_n]}")
    out["single_in_batch"] = bool(torch.equal(one[1][0], many[1][0]))
    # The CPU plain path over the same codes and the same weights.
    cpu_model = model_copy(model, torch.device("cpu"))
    _, cpu_ids = two_tower_retrieve(cpu_model, cfg, hist.cpu(), enc.packed.cpu(),
                                    enc.qnorms.cpu(), k=10)
    out["ids_equal_cpu"] = float((many[1].cpu() == cpu_ids).float().mean())
    u = rs.user_embedding(model, cfg, hist)
    scores = rs.score_candidates_f32(u, items)
    _, exact = exact_topk(scores, 10)
    out["overlap_exact"] = float(np.mean([len(set(a) & set(b)) / 10 for a, b in
                                          zip(many[1].tolist(), exact.tolist())]))
    # What sets that overlap: how close the unit item vectors lie (their mean
    # pairwise cosine), and each user's exact 10th - 11th score gap against
    # the 4-bit codes' score error at the returned ids (a scan score is
    # sqrt(d') x the estimated cosine: both rotations are unnormalised).
    total, sq = items.double().sum(0), float(items.double().square().sum())
    n = items.shape[0]
    out["item_mean_cos"] = (float(total @ total) - sq) / (n * (n - 1))
    top11 = torch.topk(scores, 11, dim=1).values
    gap = top11[:, 9] - top11[:, 10]
    err = (many[0] / math.sqrt(enc.dim_pad) - scores.gather(1, many[1].long())).abs()
    out["gap_10_11"] = {"median": float(gap.median()), "min": float(gap.min())}
    out["code_err"] = {"median": float(err.median()), "max": float(err.max())}
    report_line(f"{part} spread: item vectors' mean pairwise cosine {out['item_mean_cos']:.4f}; "
                f"exact 10th - 11th score gap median {out['gap_10_11']['median']:.3e} (min "
                f"{out['gap_10_11']['min']:.3e}); 4-bit score error at the returned ids median "
                f"{out['code_err']['median']:.3e} (max {out['code_err']['max']:.3e})")
    lat = {}
    for name, h in (("1", hist[:1]), (str(z.tt_users), hist)):
        times = []
        for _ in range(z.tt_reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            two_tower_retrieve(model, cfg, h, enc.packed, enc.qnorms, k=10)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        lat[name] = {"median_ms": float(np.median(times)), "p90_ms": float(np.quantile(times, 0.9))}
    out["latency"] = lat
    report_line(f"{part} retrieve top-10 of {z.tt_items:,}: ids equal to the CPU plain path's "
                f"over the same codes in {out['ids_equal_cpu']:.4f} of slots (>= 0.99 held); "
                f"overlap with the exact f32 top-10 {out['overlap_exact']:.4f} (reported); batch "
                f"latency (CUDA events, {z.tt_reps} runs) {lat}; launches encode "
                f"{launches[enc_n]['fwht']} B2, retrieve {launches[ret_n]['fwht']} "
                f"B2 + {launches[ret_n]['nibble_dot']} B1")
    expect(out["ids_equal_cpu"] >= 0.99,
           f"{part}: ids equal to the CPU plain path's in {out['ids_equal_cpu']:.4f} of slots")
    del cpu_model, items, enc, u, scores
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_parity_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """12c: every other registry arch at its smoke config on the card against
    the CPU plain forward of the same weights; three LMs at full width,
    forward against prefill + decode, decode twice byte-identical."""
    from repro_torch import configs
    from repro_torch.data import synthetic as syn
    from repro_torch.dist.steps import rs_forward
    from repro_torch.models import gnn, recsys as rs, transformer as tf

    out: dict = {"smoke": {}, "full": {}}
    cpu = torch.device("cpu")

    def gap(got, want, tol):
        d = float((got.cpu().double() - want.double()).abs().max())
        ok = bool(((got.cpu().double() - want.double()).abs()
                   <= tol * (1 + want.double().abs())).all())
        return {"max_abs": d, "within": ok, "tol": tol}

    with launches_into(launches, "12c_smoke", counters):
        for arch_id in z.lm_archs:
            cfg = configs.get(arch_id).make_smoke()
            host = tf.Transformer(cfg, torch.Generator().manual_seed(z.seed), cpu)
            card = model_copy(host, dev)
            toks = syn.lm_batch(z.seed, 0, 2, 16, cfg.vocab)["tokens"]
            res = {"forward": gap(tf.forward(card, cfg, torch.tensor(toks, device=dev))[0],
                                  tf.forward(host, cfg, torch.tensor(toks))[0], ZOO_SMOKE_TOL)}
            for name, quantized in (("decode_bf16", False), ("decode_4bit", True)):
                lc, _, _ = decode_run(torch, tf, card, cfg, torch.tensor(toks, device=dev),
                                      z.smoke_steps, batch=2, max_len=16, quantized=quantized,
                                      dev=dev)
                ch = tf.init_decode_cache(cfg, 2, 16, quantized=quantized, device=cpu)
                lh = []
                for t in range(z.smoke_steps):
                    lg, ch = tf.decode_step(host, cfg, ch, torch.tensor(toks[:, t:t + 1]), t,
                                            quantized=quantized)
                    lh.append(lg)
                tol = ZOO_SMOKE_Q_TOL if quantized and not cfg.mla else ZOO_SMOKE_TOL
                res[name] = gap(lc, torch.stack(lh, 1), tol)
            out["smoke"][arch_id] = res
        g_cfg = configs.get("gin-tu").make_smoke()
        g_host = gnn.GIN(g_cfg, torch.Generator().manual_seed(z.seed), cpu)
        g_card = model_copy(g_host, dev)
        g = syn.random_graph(z.seed, 200, 800, g_cfg.d_feat, g_cfg.n_classes)
        full = [torch.tensor(g[k]) for k in ("x", "src", "dst")]
        res = {"forward_full": gap(gnn.forward_full(g_card, g_cfg, *(t.to(dev) for t in full)),
                                   gnn.forward_full(g_host, g_cfg, *full), ZOO_SMOKE_TOL)}
        order = np.argsort(g["src"], kind="stable")
        indptr = np.concatenate([[0], np.cumsum(np.bincount(g["src"], minlength=200))])
        frontier, blocks = syn.neighbor_sample(z.seed, 0, indptr, g["dst"][order],
                                               np.arange(16), (5, 3))
        feats = torch.tensor(g["x"][frontier])
        tb = [(torch.tensor(s), torch.tensor(d), n) for s, d, n in blocks]
        res["forward_sampled"] = gap(
            gnn.forward_sampled(g_card, g_cfg, feats.to(dev),
                                [(s.to(dev), d.to(dev), n) for s, d, n in tb]),
            gnn.forward_sampled(g_host, g_cfg, feats, tb), ZOO_SMOKE_TOL)
        out["smoke"]["gin-tu"] = res
        makers = {"dlrm-rm2": rs.DLRM, "dien": rs.DIEN, "fm": rs.FM,
                  "two-tower-retrieval": rs.TwoTower}
        for arch_id, cls in makers.items():
            cfg = configs.get(arch_id).make_smoke()
            host = cls(cfg, torch.Generator().manual_seed(z.seed), cpu)
            card = model_copy(host, dev)
            batch = syn.recsys_batch(z.seed, 0, arch_id, cfg, 64)
            out["smoke"][arch_id] = {"rs_forward": gap(
                rs_forward(arch_id, card, cfg, {k: torch.tensor(v, device=dev)
                                                for k, v in batch.items()}),
                rs_forward(arch_id, host, cfg, {k: torch.tensor(v) for k, v in batch.items()}),
                ZOO_SMOKE_TOL)}
    for arch_id, res in out["smoke"].items():
        report_line(f"12c smoke {arch_id} card vs CPU: " + "; ".join(
            f"{k} max |diff| {v['max_abs']:.3e} (tol {v['tol']})" for k, v in res.items()))
        for k, v in res.items():
            expect(v["within"], f"12c: {arch_id} {k} on the card differs from the CPU plain "
                                f"forward: {v}")

    for arch_id in z.full_archs:
        cfg = z.full_config(arch_id)
        if cfg.moe:        # capacity raised so the forward drops no token (as decode)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k))
        t0 = time.perf_counter()
        model = tf.Transformer(cfg, torch.Generator(dev).manual_seed(z.seed), dev)
        b, s = z.full_tokens
        toks = torch.tensor(syn.lm_batch(z.seed, 2, b, s, cfg.vocab)["tokens"], device=dev)
        with launches_into(launches, f"12c_{arch_id}", counters):
            res = decode_parity(torch, tf, model, cfg, toks, s - z.full_decode, dev)
        torch.cuda.synchronize()
        res.update(params=sum(p.numel() for p in model.parameters()),
                   seconds=time.perf_counter() - t0)
        out["full"][arch_id] = res
        report_line(f"12c full {arch_id}: {res['params']:,} parameters; prefill {b} x "
                    f"{s - z.full_decode} + {z.full_decode} decode steps vs forward: "
                    f"{parity_line(res)}; {res['seconds']:.1f} s")
        expect(res["ok"], f"12c: {arch_id} prefill / decode vs forward: {res}")
        expect(res["deterministic"], f"12c: {arch_id}: two runs differ")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zoo_sizes(configs) -> SimpleNamespace:
    """Phase 12's shapes (the rehearsal on the CPU swaps in smaller ones)."""
    return SimpleNamespace(
        seed=SEED, llama="llama3.2-3b", lm_prefill=(4, 512), lm_decode=32, q_batch=8,
        q_max_len=1024, q_steps=64, record_step=10, tt_items=1_000_000, tt_users=64,
        tt_reps=20, lm_archs=("gemma2-2b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b",
                              "olmoe-1b-7b"),
        full_archs=("qwen1.5-0.5b", "gemma2-2b", "olmoe-1b-7b"), full_tokens=(2, 256),
        full_decode=16, smoke_steps=10,
        full_config=lambda arch_id: configs.get(arch_id).make_config())


def zoo_child(report_path: str) -> int:
    """Phase 12's child: 12a, 12b and 12c on the card, the report written to
    ``report_path``; non-zero when the card is missing, a part raised or a
    check failed (the report lists the failed checks)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 12: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()

    def report_line(text: str) -> None:
        say(f"{text} [{smi}]")

    counters = kernel_counters()
    z = zoo_sizes(configs)
    report: dict = {"gpu": smi, "launches": {}}
    for part, fn in (("12a", llama_phase), ("12b", two_tower_phase), ("12c", zoo_parity_phase)):
        t0 = time.perf_counter()
        report[part] = fn(torch, np, dev, z, expect, report_line, counters, report["launches"])
        report[part]["seconds"] = time.perf_counter() - t0
        report_line(f"phase {part}: {report[part]['seconds']:.1f} s")
    report["failures"] = FAILURES
    Path(report_path).write_text(json.dumps(report))
    return 1 if FAILURES else 0


def zoo_phase(c) -> dict:
    """Phase 12: run ``zoo_child`` in a child process with ``PHASE12_ENV``
    added, relay its output and every check that failed there."""
    report = run_child("--phase12-child", PHASE12_ENV, PHASE12_TIMEOUT_S, "phase 12", c.expect)
    if report is None:
        return {"launches": {}}
    for failure in report["failures"]:
        c.expect(False, f"phase 12 (child): {failure}")
    return report


# ---------------------------------------------------------------------------
# Phase 13: training on the card (child process).
# ---------------------------------------------------------------------------

def tensor_digest(torch, named) -> str:
    """A digest of the bytes of ``(name, tensor)`` pairs, taken on their
    device: per tensor, the int64 sums of its raw values and of its values
    times a position weight (one differing element moves the first)."""
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().contiguous()
        raw = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        x = t.view(raw).reshape(-1)
        s1 = s2 = 0
        for i in range(0, x.numel(), DIGEST_SLICE):
            c = x[i:i + DIGEST_SLICE].to(torch.int64)
            w = torch.arange(i, i + c.numel(), dtype=torch.int64, device=c.device) % 1_000_003 + 1
            s1 += int(c.sum())
            s2 += int((c * w).sum())
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype}:{s1}:{s2};".encode())
    return h.hexdigest()


def state_digest(torch, model, state: dict) -> str:
    """``tensor_digest`` of every parameter, both moments and the step."""
    named = list(model.named_parameters())
    for part in ("m", "v", "ef"):
        named += [(f"{part}.{k}", t) for k, t in state.get(part, {}).items()]
    return tensor_digest(torch, named + [("step", state["step"])])


def timed_steps(torch, step, model, state, batches) -> tuple:
    """Run ``step`` over ``batches``; (model, state, losses, grad norms, step
    ms by CUDA events: each step's loss is read back inside its window)."""
    losses, gnorms, times = [], [], []
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        end.record()
        end.synchronize()
        gnorms.append(float(m["grad_norm"]))
        times.append(start.elapsed_time(end))
    return model, state, losses, gnorms, times


def llama_train_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """13a: llama3.2-3b at full width trains 8 steps of B x 4,096 tokens
    (remat "full", loss_chunk 2048, AdamW defaults, f32 moments), twice from
    the same seeded weights: every loss finite, the two runs' losses and the
    bytes of every parameter and moment equal; step time, tokens/s, peak
    memory and one traced step reported."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, make_train_step

    cfg = dataclasses.replace(z.full_config(z.llama), loss_chunk=z.loss_chunk)
    ocfg = AdamWConfig()
    b, s = z.lm_tokens
    batches = [torch.tensor(lm_batch(z.seed, i, b, s, cfg.vocab)["tokens"], device=dev)
               for i in range(z.lm_steps)]
    step = make_train_step(lambda m, t: tf.lm_loss(m, cfg, t), ocfg)
    out: dict = {"runs": []}
    with launches_into(launches, "13a", counters):
        for run in range(2):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = tf.Transformer(cfg, torch.Generator(dev).manual_seed(z.seed), dev)
            state = init_opt_state(model, ocfg)
            model, state, losses, gnorms, times = timed_steps(torch, step, model, state, batches)
            res = {"losses": losses, "grad_norms": gnorms, "step_ms": times,
                   "digest": state_digest(torch, model, state),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            if run == 0:
                out["params"] = sum(p.numel() for p in model.parameters())
                out["profile"] = profile_window(torch, lambda: step(model, state, batches[0]),
                                                "13a llama3.2-3b train step (eager)",
                                                warm_up=False)
            out["runs"].append(res)
            del model, state
    r0, r1 = out["runs"]
    med = float(np.median(r0["step_ms"][1:] + r1["step_ms"][1:]))
    out.update(step_ms_median=med, tokens_per_s=b * s / (med / 1e3))
    report_line(f"13a {cfg.name}: {out['params']:,} parameters ({cfg.dtype}, remat "
                f"{cfg.remat_policy}, loss_chunk {cfg.loss_chunk}), {z.lm_steps} steps of "
                f"{b} x {s} tokens, twice: losses {r0['losses']}; grad norms {r0['grad_norms']}")
    report_line(f"13a step (CUDA events, steps 2-{z.lm_steps} of both runs) median {med:.1f} ms "
                f"= {out['tokens_per_s']:.0f} tokens/s; first steps {r0['step_ms'][0]:.1f} / "
                f"{r1['step_ms'][0]:.1f} ms; peak allocated {r0['peak_bytes']:,} / "
                f"{r1['peak_bytes']:,} B; traced step: device busy "
                f"{out['profile']['device_busy_us'] / 1e3:.1f} ms of "
                f"{out['profile']['wall_us'] / 1e3:.1f}, idle share "
                f"{out['profile']['idle_share']:.3f}")
    expect(all(math.isfinite(x) for x in r0["losses"] + r1["losses"]),
           f"13a: a loss is not finite: {r0['losses']} {r1['losses']}")
    expect(r0["losses"] == r1["losses"], f"13a: the two runs' losses differ "
                                         f"{r0['losses']} {r1['losses']}")
    expect(r0["digest"] == r1["digest"], "13a: the two runs' parameters or moments differ")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_gap(torch, host, card, lr: float) -> dict:
    """Parameters after one step on the CPU and on the card: max |diff|,
    whether all are within TRAIN_PARAM_ATOL_LR x lr, and the elements beyond
    TRAIN_TIGHT_TOL against their limit."""
    max_abs, n_far, n_all = 0.0, 0, 0
    card_params = dict(card.named_parameters())
    for k, p in host.named_parameters():
        c = card_params[k].detach()
        d = (c.double() - p.detach().to(c.device, torch.float64)).abs()
        max_abs = max(max_abs, float(d.max()) if d.numel() else 0.0)
        n_far += int((d > TRAIN_TIGHT_TOL).sum())
        n_all += d.numel()
    far_limit = max(TRAIN_FAR_SHARE * n_all, TRAIN_FAR_MIN)
    return {"max_abs": max_abs, "beyond_tight": n_far, "elements": n_all,
            "far_limit": far_limit, "within": max_abs <= TRAIN_PARAM_ATOL_LR * lr,
            "far_within": n_far <= far_limit}


def capture_grads(model) -> dict:
    """Turn ``model``'s gradients on and return a dict that hooks fill with
    each parameter's gradient as backward leaves it (``make_train_step``
    frees them after its update)."""
    grads: dict = {}
    model.requires_grad_(True)
    for k, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(lambda p, k=k: grads.__setitem__(k, p.grad))
    return grads


def grad_gap(torch, host: dict, card: dict, names) -> dict:
    """Gradients on the card against the CPU's, leaf by leaf: the worst
    relative L2 distance and the worst max |diff| over the leaf's max |g|.
    A leaf's scale is floored at TRAIN_GRAD_FLOOR of the whole gradient's
    (its global norm, its largest element): a gradient that is zero but for
    rounding, as that of a bias before a softmax, reads at its rounding
    level (measured: dien's ``att.b``, ~1e-11 against a norm of 0.34, differs
    by 15x its own norm between card and CPU).  A parameter that backward
    never reached, as the router bias, has a zero gradient."""
    pairs = []
    for k in names:
        h, c = host.get(k), card.get(k)
        if h is None and c is None:
            continue
        c = c.detach().double() if c is not None else None
        h = (h.detach().to(c.device if c is not None else h.device, torch.float64)
             if h is not None else torch.zeros_like(c))
        pairs.append((k, h, c if c is not None else torch.zeros_like(h)))
    norm = math.sqrt(sum(float(torch.linalg.vector_norm(h)) ** 2 for _, h, _ in pairs))
    top = max((float(h.abs().max()) for _, h, _ in pairs if h.numel()), default=0.0)
    floor_l2, floor_max = TRAIN_GRAD_FLOOR * norm, TRAIN_GRAD_FLOOR * top
    worst, score = {"l2": 0.0, "max": 0.0, "leaf": None}, -1.0
    for k, h, c in pairs:
        d = c - h
        l2 = float(torch.linalg.vector_norm(d)) / max(float(torch.linalg.vector_norm(h)),
                                                      floor_l2, 1e-30)
        mx = float(d.abs().max()) / max(float(h.abs().max()), floor_max, 1e-30)
        if max(l2, mx) > score:
            score, worst["leaf"] = max(l2, mx), k
        worst["l2"], worst["max"] = max(worst["l2"], l2), max(worst["max"], mx)
    worst["within"] = worst["l2"] <= TRAIN_GRAD_REL and worst["max"] <= TRAIN_GRAD_REL
    return worst


def train_step_pair(torch, dev, host, loss_fn, batch_host, batch_card) -> dict:
    """One AdamW step (lr TRAIN_LR) of ``host`` on the CPU and of two card
    copies: loss, grad norm, every gradient leaf and the parameters card
    against CPU, and the two card steps byte for byte (parameters and
    moments)."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, make_train_step

    ocfg = AdamWConfig(lr=TRAIN_LR)
    cards = [model_copy(host, dev), model_copy(host, dev)]
    names = [k for k, _ in host.named_parameters()]
    grads = [capture_grads(host), capture_grads(cards[0])]
    step = make_train_step(loss_fn, ocfg)
    runs = []
    for m, batch in ((host, batch_host), (cards[0], batch_card), (cards[1], batch_card)):
        m, st, met = step(m, init_opt_state(m, ocfg), batch)
        runs.append((m, st, float(met["loss"]), float(met["grad_norm"])))
    (h, _, h_loss, h_norm), (c, c_st, c_loss, c_norm), (c2, c2_st, c2_loss, _) = runs
    same = (c_loss == c2_loss and state_digest(torch, c, c_st) == state_digest(torch, c2, c2_st))
    return {"loss": [c_loss, h_loss], "grad_norm": [c_norm, h_norm],
            "loss_within": abs(c_loss - h_loss) <= TRAIN_LOSS_RTOL * abs(h_loss),
            "norm_within": abs(c_norm - h_norm) <= TRAIN_NORM_RTOL * abs(h_norm),
            "grads": grad_gap(torch, grads[0], grads[1], names),
            "params": step_gap(torch, h, c, TRAIN_LR), "repeat_equal": same}


def pair_line(res: dict) -> str:
    p, g = res["params"], res["grads"]
    return (f"loss {res['loss'][0]:.7f} / CPU {res['loss'][1]:.7f}, grad norm "
            f"{res['grad_norm'][0]:.6f} / {res['grad_norm'][1]:.6f} (rtol {TRAIN_LOSS_RTOL:.0e} / "
            f"{TRAIN_NORM_RTOL:.0e}); gradients leaf by leaf: worst relative L2 "
            f"{g['l2']:.3e}, worst max |diff| / max |g| {g['max']:.3e} (<= {TRAIN_GRAD_REL:.0e}; "
            f"worst leaf {g['leaf']}); parameters max |diff| {p['max_abs']:.3e} (<= "
            f"{TRAIN_PARAM_ATOL_LR * TRAIN_LR:.1e}), {p['beyond_tight']:,} of {p['elements']:,} "
            f"beyond {TRAIN_TIGHT_TOL:.0e} (<= {p['far_limit']:,.0f}); repeat byte-identical "
            f"{res['repeat_equal']}")


def pair_checks(expect, label: str, res: dict) -> None:
    expect(res["loss_within"], f"{label}: loss on the card vs CPU {res['loss']}")
    expect(res["norm_within"], f"{label}: grad norm on the card vs CPU {res['grad_norm']}")
    expect(res["grads"]["within"], f"{label}: gradients on the card vs CPU {res['grads']}")
    expect(res["params"]["within"], f"{label}: parameters after one step {res['params']}")
    expect(res["params"]["far_within"],
           f"{label}: parameters beyond {TRAIN_TIGHT_TOL:.0e} after one step {res['params']}")
    expect(res["repeat_equal"], f"{label}: two steps on the card differ")


def restart_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """13b: llama3.2-3b cut to z.cut_layers layers (every width and the
    vocab kept, bf16): 12 uninterrupted steps of 1 x 512 tokens (a
    checkpoint every 4, keep 2) against a run that crashes at step 9 and
    resumes at 8 from its own directory: losses, parameters and moments byte
    for byte (the first restore of bf16 leaves); then one f32 step on the
    card against the CPU plain path."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train import CheckpointManager, SimulatedFailure, train
    from repro_torch.train.optimizer import AdamWConfig

    cfg = dataclasses.replace(z.full_config(z.llama), n_layers=z.cut_layers,
                              loss_chunk=z.loss_chunk)
    b, s = z.restart_tokens
    seconds = {"save": [], "restore": []}

    class TimedCheckpoints(CheckpointManager):
        def save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            path = super().save(step, tree, extra)
            seconds["save"].append(time.perf_counter() - t0)
            return path

        def restore(self, *args, **kw):
            t0 = time.perf_counter()
            got = super().restore(*args, **kw)
            seconds["restore"].append(time.perf_counter() - t0)
            return got

    def run(directory, fail_at=None):
        return train(
            loss_fn=lambda m, t: tf.lm_loss(m, cfg, t),
            init_params_fn=lambda: tf.Transformer(cfg, torch.Generator(dev).manual_seed(z.seed),
                                                  dev),
            batch_fn=lambda i: torch.tensor(lm_batch(z.seed, i, b, s, cfg.vocab)["tokens"],
                                            device=dev),
            n_steps=z.restart_steps, opt_cfg=AdamWConfig(),
            ckpt=TimedCheckpoints(str(directory), keep=z.keep), ckpt_every=z.ckpt_every,
            simulate_failure_at=fail_at)

    out: dict = {}
    with launches_into(launches, "13b", counters), tempfile.TemporaryDirectory() as td:
        td = Path(td)
        out["disk_free_bytes"] = shutil.disk_usage(td).free
        ref = run(td / "a")
        last = td / "a" / f"step_{z.restart_steps:08d}"
        out["checkpoint_bytes"] = sum(f.stat().st_size for f in last.iterdir())
        out["kept"] = sorted(p.name for p in (td / "a").iterdir())
        shutil.rmtree(td / "a")
        try:
            run(td / "b", fail_at=z.fail_at)
            crashed = False
        except SimulatedFailure:
            crashed = True
        gc.collect()
        resume_dir = td / "b" / f"step_{z.fail_at - 1:08d}"
        manifest = (json.loads((resume_dir / "manifest.json").read_text())
                    if resume_dir.exists() else {"leaves": []})
        out["bf16_leaves"] = sum(e["dtype"] == "bfloat16" for e in manifest["leaves"])
        resumed = run(td / "b")
        out["params"] = sum(p.numel() for p in ref.params.parameters())
    same_params = all(bytes_equal(torch, a, bb) for (_, a), (_, bb) in
                      zip(ref.params.state_dict().items(), resumed.params.state_dict().items()))
    same_moments = all(bytes_equal(torch, ref.opt_state[part][k], resumed.opt_state[part][k])
                       for part in ("m", "v") for k in ref.opt_state[part])
    same_step = bytes_equal(torch, ref.opt_state["step"], resumed.opt_state["step"])
    dtypes = sorted({str(p.dtype) for p in resumed.params.parameters()})
    tail = ref.losses[z.fail_at - 1:]
    out.update(crashed=crashed, start_step=resumed.start_step, losses=ref.losses,
               resumed_losses=resumed.losses, save_s=seconds["save"],
               restore_s=seconds["restore"], same_params=same_params,
               same_moments=same_moments and same_step, dtypes=dtypes)
    report_line(f"13b {cfg.name} cut to {z.cut_layers} layers ({out['params']:,} parameters, "
                f"{cfg.dtype}), {z.restart_steps} steps of {b} x {s}: losses {ref.losses}; "
                f"crash at {z.fail_at} -> resume at {resumed.start_step}: losses "
                f"{resumed.losses} (equal: {resumed.losses == tail}), parameters and moments "
                f"byte-identical {same_params and out['same_moments']}; {out['bf16_leaves']} "
                f"bf16 leaves restored")
    report_line(f"13b checkpoints: {out['checkpoint_bytes']:,} B each on disk "
                f"({out['disk_free_bytes']:,} B free), kept {out['kept']}; save s "
                f"{[round(x, 2) for x in seconds['save']]}, restore s "
                f"{[round(x, 2) for x in seconds['restore']]}")
    expect(crashed, "13b: the run did not crash at the injected step")
    expect(resumed.start_step == z.fail_at - 1,
           f"13b: resumed at {resumed.start_step}, not {z.fail_at - 1}")
    expect(resumed.losses == tail, f"13b: resumed losses {resumed.losses} against {tail}")
    expect(same_params and out["same_moments"], "13b: resumed parameters or moments differ")
    expect(out["bf16_leaves"] > 0 and "torch.bfloat16" in dtypes,
           f"13b: no bf16 leaf was restored ({out['bf16_leaves']}, {dtypes})")
    expect(len(out["kept"]) == z.keep, f"13b: keep {z.keep} left {out['kept']}")
    del ref, resumed
    gc.collect()
    torch.cuda.empty_cache()

    # One f32 step on the card against the CPU plain path (the weights drawn
    # on the card, copied to the host).
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    host = model_copy(tf.Transformer(cfg32, torch.Generator(dev).manual_seed(z.seed), dev),
                      torch.device("cpu"))
    toks = lm_batch(z.seed, 0, b, s, cfg.vocab)["tokens"]
    t0 = time.perf_counter()
    with launches_into(launches, "13b_f32", counters):
        out["f32_step"] = train_step_pair(torch, dev, host, lambda m, t: tf.lm_loss(m, cfg32, t),
                                          torch.tensor(toks), torch.tensor(toks, device=dev))
    out["f32_step"]["seconds"] = time.perf_counter() - t0
    report_line(f"13b f32 step, card vs CPU plain path ({out['f32_step']['seconds']:.1f} s): "
                f"{pair_line(out['f32_step'])}")
    pair_checks(expect, "13b f32", out["f32_step"])
    del host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_tower_train_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """13c: two-tower-retrieval at full width trains 8 steps of
    ``recsys_train``'s 65,536 (in-batch softmax with logQ, AdamW lr 1e-3),
    twice byte for byte; the trained towers' gradient on z.tt_grad_rows rows
    is held to the CPU plain path's leaf by leaf; the trained towers then
    encode ``retrieval_cand``'s 1,000,000 items (B2) and serve 64 users (B2 +
    B1) as 12b."""
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import recsys as rs
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, make_train_step

    cfg = z.full_config("two-tower-retrieval")
    ocfg = AdamWConfig(lr=1e-3)
    step = make_train_step(lambda m, bt: rs.two_tower_loss(m, cfg, bt), ocfg)

    def batch(i):
        return {k: torch.tensor(v, device=dev) for k, v in
                recsys_batch(z.seed, i, "two-tower-retrieval", cfg, z.tt_batch).items()}

    out: dict = {"runs": []}
    model = None
    with launches_into(launches, "13c_train", counters):
        for run in range(2):
            del model
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = rs.TwoTower(cfg, torch.Generator(dev).manual_seed(z.seed), dev)
            state = init_opt_state(model, ocfg)
            model, state, losses, gnorms, times = timed_steps(
                torch, step, model, state, (batch(i) for i in range(z.tt_steps)))
            out["runs"].append({"losses": losses, "grad_norms": gnorms, "step_ms": times,
                                "digest": state_digest(torch, model, state),
                                "peak_bytes": torch.cuda.max_memory_allocated()})
            del state
    r0, r1 = out["runs"]
    same = r0["digest"] == r1["digest"] and r0["losses"] == r1["losses"]
    report_line(f"13c {cfg.name} training: {z.tt_steps} steps of {z.tt_batch:,}, twice: losses "
                f"{r0['losses']}; step ms {[round(x, 1) for x in r0['step_ms']]}; peak allocated "
                f"{r0['peak_bytes']:,} / {r1['peak_bytes']:,} B; runs byte-identical {same}")
    expect(all(math.isfinite(x) for x in r0["losses"]), f"13c: a loss is not finite {r0}")
    expect(same, "13c: the two training runs differ")
    # The trained towers' gradient at full width on z.tt_grad_rows rows, card
    # against the CPU plain path leaf by leaf (the 2^21-row tables' backward
    # included).
    rows = recsys_batch(z.seed, z.tt_steps, "two-tower-retrieval", cfg, z.tt_grad_rows)
    host = model_copy(model, torch.device("cpu"))
    names = [k for k, _ in model.named_parameters()]
    grads = [capture_grads(host), capture_grads(model)]
    t0 = time.perf_counter()
    for m, d in ((host, torch.device("cpu")), (model, dev)):
        batch = {k: torch.tensor(v, device=d) for k, v in rows.items()}
        rs.two_tower_loss(m, cfg, batch).backward()
    out["grad"] = grad_gap(torch, grads[0], grads[1], names)
    out["grad"]["seconds"] = time.perf_counter() - t0
    g = out["grad"]
    report_line(f"13c gradient at full width, {z.tt_grad_rows:,} rows, card vs CPU plain path "
                f"({g['seconds']:.1f} s): worst relative L2 {g['l2']:.3e}, worst max |diff| / "
                f"max |g| {g['max']:.3e} (<= {TRAIN_GRAD_REL:.0e}; worst leaf {g['leaf']})")
    expect(out["grad"]["within"], f"13c: gradients on the card vs CPU {out['grad']}")
    for g in grads:
        g.clear()
    del host, grads
    for p in model.parameters():
        p.grad = None
    model.requires_grad_(False)
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = two_tower_serve(torch, np, dev, z, model, cfg, "13c", expect, report_line,
                                   counters, launches)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def smoke_train_phase(torch, np, dev, z, expect, report_line, counters, launches) -> dict:
    """13d: one training step of every other arch at its smoke config on the
    card against the CPU plain path of the same weights (loss, grad norm,
    every gradient leaf, parameters), each card step twice byte for byte; then
    ``python -m repro_torch.launch.train`` in-process on the card, twice."""
    from repro_torch import configs
    from repro_torch.data import synthetic as syn
    from repro_torch.dist.steps import _RS_INIT, _RS_LOSS
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn, transformer as tf

    cpu = torch.device("cpu")
    out: dict = {"smoke": {}}

    def both(batch: dict):
        return ({k: torch.tensor(v) for k, v in batch.items()},
                {k: torch.tensor(v, device=dev) for k, v in batch.items()})

    def gin(cfg):
        return gnn.GIN(cfg, torch.Generator().manual_seed(z.seed), cpu)

    with launches_into(launches, "13d", counters):
        for arch_id in z.smoke_lms:
            cfg = configs.get(arch_id).make_smoke()
            host = tf.Transformer(cfg, torch.Generator().manual_seed(z.seed), cpu)
            toks = syn.lm_batch(z.seed, 0, 2, 16, cfg.vocab)["tokens"]
            out["smoke"][arch_id] = train_step_pair(
                torch, dev, host, lambda m, t, cfg=cfg: tf.lm_loss(m, cfg, t),
                torch.tensor(toks), torch.tensor(toks, device=dev))
        g_cfg = configs.get("gin-tu").make_smoke()
        g = syn.random_graph(z.seed, 200, 800, g_cfg.d_feat, g_cfg.n_classes)
        g["mask"] = (np.arange(200) % 3 == 0).astype(np.float32)
        out["smoke"]["gin-tu full"] = train_step_pair(
            torch, dev, gin(g_cfg),
            lambda m, bt: gnn.nll_loss(gnn.forward_full(m, g_cfg, bt["x"], bt["src"], bt["dst"]),
                                       bt["labels"], bt["mask"]), *both(g))
        order = np.argsort(g["src"], kind="stable")
        indptr = np.concatenate([[0], np.cumsum(np.bincount(g["src"], minlength=200))])
        frontier, blocks = syn.neighbor_sample(z.seed, 0, indptr, g["dst"][order],
                                               np.arange(16), (5, 3))
        sampled = {"feats": g["x"][frontier], "labels": g["labels"][:16]}
        for i, (src, dst, _) in enumerate(blocks):
            sampled[f"src{i}"], sampled[f"dst{i}"] = src, dst
        sizes = [n for _, _, n in blocks]
        out["smoke"]["gin-tu sampled"] = train_step_pair(
            torch, dev, gin(g_cfg),
            lambda m, bt: gnn.nll_loss(gnn.forward_sampled(
                m, g_cfg, bt["feats"], [(bt[f"src{i}"], bt[f"dst{i}"], n)
                                        for i, n in enumerate(sizes)]), bt["labels"]),
            *both(sampled))
        r_cfg = dataclasses.replace(g_cfg, readout="graph")
        mol = syn.random_graph(z.seed + 3, 240, 512, r_cfg.d_feat, r_cfg.n_classes)
        mol = {"x": mol["x"], "src": mol["src"] % 240, "dst": mol["dst"] % 240,
               "gid": np.repeat(np.arange(8), 30), "y": np.arange(8) % r_cfg.n_classes}
        out["smoke"]["gin-tu graphs"] = train_step_pair(
            torch, dev, gin(r_cfg),
            lambda m, bt: gnn.nll_loss(gnn.forward_full(
                m, r_cfg, bt["x"], bt["src"], bt["dst"], graph_ids=bt["gid"], n_graphs=8),
                bt["y"]), *both(mol))
        for arch_id in z.smoke_recsys:
            cfg = configs.get(arch_id).make_smoke()
            out["smoke"][arch_id] = train_step_pair(
                torch, dev, _RS_INIT[arch_id](cfg, torch.Generator().manual_seed(z.seed), cpu),
                lambda m, bt, a=arch_id, c=cfg: _RS_LOSS[a](m, c, bt),
                *both(syn.recsys_batch(z.seed, 0, arch_id, cfg, 64)))
    for name, res in out["smoke"].items():
        report_line(f"13d smoke {name} one step, card vs CPU: {pair_line(res)}")
        pair_checks(expect, f"13d {name}", res)

    argv = ["--arch", z.launch_arch, "--steps", str(z.launch_steps)]
    runs = []
    with launches_into(launches, "13d_launch", counters):
        for _ in range(2):
            res = launch_train.main(argv)
            runs.append((res.losses, tensor_digest(torch, res.params.named_parameters())))
    losses = runs[0][0]
    out["launch"] = {"argv": argv, "losses": losses, "repeat_equal": runs[0] == runs[1]}
    report_line(f"13d python -m repro_torch.launch.train {' '.join(argv)} (in-process, twice): "
                f"losses {losses}; repeat byte-identical {runs[0] == runs[1]}")
    expect(np.mean(losses[-3:]) < losses[0], f"13d: launch.train's loss did not fall {losses}")
    expect(runs[0] == runs[1], "13d: two launch.train runs differ")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_sizes(configs) -> SimpleNamespace:
    """Phase 13's shapes (the rehearsal on the CPU swaps in smaller ones)."""
    return SimpleNamespace(
        seed=SEED, llama="llama3.2-3b", lm_tokens=(2, 4096), lm_steps=8, loss_chunk=2048,
        cut_layers=2, restart_tokens=(1, 512), restart_steps=12, ckpt_every=4, keep=2,
        fail_at=9, tt_batch=65536, tt_steps=8, tt_grad_rows=8192, tt_items=1_000_000,
        tt_users=64, tt_reps=20,
        smoke_lms=("gemma2-2b", "qwen1.5-0.5b", "deepseek-v3-671b", "olmoe-1b-7b"),
        smoke_recsys=("dlrm-rm2", "dien", "fm", "two-tower-retrieval"),
        launch_arch="qwen1.5-0.5b", launch_steps=8,
        full_config=lambda arch_id: configs.get(arch_id).make_config())


def train_child(report_path: str) -> int:
    """Phase 13's child: 13a-13d on the card under
    ``torch.use_deterministic_algorithms(True)``, the report written to
    ``report_path``; non-zero when the card is missing, a part raised or a
    check failed (the report lists the failed checks)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 13: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()

    def report_line(text: str) -> None:
        say(f"{text} [{smi}]")

    counters = kernel_counters()
    z = train_sizes(configs)
    report: dict = {"gpu": smi, "launches": {},
                    "env": {k: os.environ.get(k) for k in PHASE13_ENV}}
    for part, fn in (("13a", llama_train_phase), ("13b", restart_phase),
                     ("13c", two_tower_train_phase), ("13d", smoke_train_phase)):
        t0 = time.perf_counter()
        report[part] = fn(torch, np, dev, z, expect, report_line, counters, report["launches"])
        report[part]["seconds"] = time.perf_counter() - t0
        report_line(f"phase {part}: {report[part]['seconds']:.1f} s")
    report["deterministic"] = torch.are_deterministic_algorithms_enabled()
    report["failures"] = FAILURES
    Path(report_path).write_text(json.dumps(report))
    return 1 if FAILURES else 0


def train_phase(c) -> dict:
    """Phase 13: run ``train_child`` in a child process with ``PHASE13_ENV``
    added, relay its output and every check that failed there."""
    report = run_child("--phase13-child", PHASE13_ENV, PHASE13_TIMEOUT_S, "phase 13", c.expect)
    if report is None:
        return {"launches": {}}
    for failure in report["failures"]:
        c.expect(False, f"phase 13 (child): {failure}")
    c.expect(report["deterministic"] and report["env"] == PHASE13_ENV,
             f"13: the child ran without the deterministic flag or its environment "
             f"({report['deterministic']}, {report['env']})")
    return report


# The top-k select (3b).  Its checks run on the program's adjusted scores at
# the search cells' shapes and the IVF stage's widths at nprobe 8 / 16
# (TOPK_SHAPES), at the narrow callers' (rows, width, k) (TOPK_NARROW: the
# cascade's finalize at rescore_mult 32, HNSW's beam merge at ef 64 and
# M 16, routers of 64 and 256 experts, an IVF probe of 1,024 lists, a
# two-segment merge), and on adversarial rows at TOPK_WIDTHS (width, rows)
# for each k of TOPK_KS up to the width.  ``--topk-select`` adds the sweep
# of TOPK_SWEEP's widths against the sort and the slow timings.
TOPK_SHAPES = ((256, BIG_N), (512, N), (64, 6_688), (64, 12_567))
TOPK_NARROW = ((256, 320, 10), (64, 96, 64), (512, 64, 8), (512, 256, 8), (64, 1024, 16),
               (64, 20, 10))
TOPK_WIDTHS = ((1, 64), (3, 64), (64, 64), (97, 64), (320, 64), (513, 64), (4_097, 16),
               (6_688, 16), (N, 16), (BIG_N, 4))
TOPK_KS = (1, 10, 32, 33, 64)
TOPK_SWEEP = (64, 320, 1024, 2048, 4096, 4097, 6144, 8192, 16384)
# (width, k) of narrow rows where k is a large share of the width (HNSW's
# beam merge is ef + 2M wide for the top ef), and k 64 across SORT_W.
TOPK_NARROW_SWEEP = tuple((w, k) for k in (8, 16, 32, 33, 64)
                          for w in sorted({k, k + 32, 2 * k, 4 * k, 16 * k})) + (
    (4096, 64), (4097, 64), (16384, 64))
# f32 bit patterns of the adversarial rows and of the sort's order probe.
SPECIAL_BITS = (("+0", 0x00000000), ("-0", 0x80000000), ("+inf", 0x7F800000),
                ("-inf", 0xFF800000), ("+nan", 0x7FC00000), ("-nan", 0xFFC00000),
                ("+nan.1", 0x7F800001), ("-nan.1", 0xFF800001), ("+den", 0x00000001),
                ("-den", 0x80000001), ("+max", 0x7F7FFFFF), ("-max", 0xFF7FFFFF),
                ("+1", 0x3F800000), ("-1", 0xBF800000))


def masked_sort_topk(scores, k: int, live=None) -> tuple:
    """What ``scoring.topk(scores, k, live)`` computed before the select: dead
    columns NEG, then the plain stable sort cut to k."""
    from repro_torch.core.allowlist import NEG

    if live is not None:
        scores = scores.masked_fill(~live, float(NEG))
    return exact_topk(scores, k)


def topk_select_checks(torch, np, dev, say, expect) -> tuple:
    """3b: ``kernels.topk_select`` against the masked stable sort it
    replaced, bit for bit: the sort's order on special values (and the
    kernel's on the same rows); the program's adjusted scores at
    ``TOPK_SHAPES`` (a 45,000 x 1024 stand-in index; 1,000,000 random 4-bit
    codes), views with a row stride among them, under no, half-live,
    0.1%-live and 3-live masks; ``TOPK_NARROW`` through ``scoring.topk``,
    two launches a call where ``fits`` and none elsewhere; adversarial rows (constant, integer ties,
    specials, +-0.0, ascending, descending) at ``TOPK_WIDTHS`` under no,
    all-dead, mostly-dead, 3-live and half-live masks at each k of
    ``TOPK_KS``; one launch pair per replay of a captured BruteForce plan,
    whose results equal the sort path's.  Returns the report and the
    program's scores at the two cells' shapes, for the timings."""
    from repro_torch import MonaVec
    from repro_torch.core import quantize as qz, scoring
    from repro_torch.core.allowlist import NEG
    from repro_torch.core.bruteforce import scan_stage
    from repro_torch.data.synthetic import embedding_corpus, queries_from_corpus
    from repro_torch.kernels import topk_select as sel

    kernel = sel.topk_select_cuda
    rng = np.random.default_rng(SEED + 30)
    out: dict = {"k_max": sel.K_MAX, "checks": 0, "failed": [], "sort_order": {}}

    def same(a, b) -> bool:
        return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y) for x, y in zip(a, b))

    def check(label, scores, k, live=None, fn=kernel) -> None:
        got, want = fn(scores, k, live), masked_sort_topk(scores, k, live)
        torch.cuda.synchronize()
        ok = same(got, want)
        out["checks"] += 1
        if not ok:
            bad = int((got[1] != want[1]).any(1).nonzero()[0, 0]) if got[1].shape == \
                want[1].shape else 0
            out["failed"].append({"label": label, "k": k, "row": bad,
                                  "got": got[1][bad, :8].tolist(),
                                  "want": want[1][bad, :8].tolist()})
        expect(ok, f"topk_select {label} k={k}: differs from the stable sort")

    def masks(w: int) -> dict:
        three = torch.zeros(w, dtype=torch.bool)
        three[torch.from_numpy(rng.choice(w, min(3, w), replace=False))] = True
        return {"none": None, "dead": torch.zeros(w, dtype=torch.bool, device=dev),
                "mostly_dead": torch.from_numpy(rng.random(w) < 1e-3).to(dev),
                "three": three.to(dev), "half": torch.from_numpy(rng.random(w) < 0.5).to(dev)}

    bits = np.array([b for _, b in SPECIAL_BITS] + [int(np.array(NEG, np.float32).view(
        np.uint32))], np.uint32)

    # The sort's order of the special values at a width (its path changes
    # with the width): the specials and NEG at columns 0..14, -1e30 after.
    names = [name for name, _ in SPECIAL_BITS] + ["NEG"]
    for w in (20, 64, 96, 320, 4096, 4100, 100_000):
        row = np.full((2, w), -1e30, np.float32)
        row[:, :len(bits)] = bits.view(np.float32)
        probe = torch.from_numpy(row).to(dev)
        order = masked_sort_topk(probe, len(bits))[1][0].tolist()
        out["sort_order"][w] = [names[i] if i < len(names) else "-1e30" for i in order]
        say(f"topk_select: the sort's order at width {w}: {' '.join(out['sort_order'][w])}")
        check(f"order probe [2 x {w}]", probe, len(bits))

    # The program's adjusted scores: the stand-in index and random 1M codes.
    t0 = time.perf_counter()
    corpus = embedding_corpus(SEED, N, DIM)
    small = MonaVec.build(corpus, metric="cosine")
    big = MonaVec.from_arrays(
        rng.integers(0, 256, size=(BIG_N, DIM // 2), dtype=np.uint8),
        rng.uniform(0.5, 1.5, BIG_N).astype(np.float32), seed=SEED, metric="cosine", bits=4,
        dim=DIM, dim_pad=DIM)

    def program_scores(index, q: np.ndarray):
        enc = index.backend.enc
        q_rot = qz.encode_query(torch.from_numpy(q).to(dev), enc)
        return scoring.adjust_scores(scan_stage(q_rot, enc.packed, bits=enc.bits),
                                     enc.qnorms, enc.metric)

    s45 = program_scores(small, queries_from_corpus(corpus, SEED + 1, 512))
    s1m = program_scores(big, rng.standard_normal((256, DIM), dtype=np.float32))
    del big
    torch.cuda.synchronize()
    say(f"topk_select: scores [512 x {N}] and [256 x {BIG_N}] in "
        f"{time.perf_counter() - t0:.1f} s; K_MAX {sel.K_MAX}")
    t0 = time.perf_counter()
    for b, w in TOPK_SHAPES:
        scores = s1m[:b, :w] if w == BIG_N else s45[:b, :w]
        m = masks(w)
        for k, live in ((10, None), (10, "half"), (1, "mostly_dead"), (64, "half"),
                        (33, "three")):
            check(f"[{b} x {w}] live={live}", scores, k, m[live] if live else None)
        if not scores.is_contiguous():
            check(f"[{b} x {w}] contiguous copy", scores.contiguous(), 10)

    # The narrow callers' rows through the program's entry point: two
    # launches a call where ``fits`` (k <= SORT_K here), none elsewhere.
    for b, w, k in TOPK_NARROW:
        live = masks(w)["half"]
        for label, scores in (("view", s45[:b, :w]), ("contiguous", s45[:b, :w].contiguous())):
            for mask in (None, live):
                before = kernel.launches
                check(f"scoring.topk [{b} x {w}] {label} live={mask is not None}", scores, k,
                      mask, fn=scoring.topk)
                want_launches = 2 if sel.fits(scores, k) else 0
                expect(kernel.launches - before == want_launches,
                       f"topk_select: scoring.topk at [{b} x {w}] k={k} launched the kernel "
                       f"{kernel.launches - before} times, not {want_launches}")

    # Adversarial rows.
    for w, b in TOPK_WIDTHS:
        rows = {"constant": torch.full((b, w), 0.25, device=dev),
                "int_ties": torch.from_numpy(rng.integers(-3, 4, (b, w)).astype(np.float32)
                                             ).to(dev),
                "specials": torch.from_numpy(
                    bits[rng.integers(0, len(bits), size=(b, w))].view(np.float32)).to(dev),
                "signed_zeros": torch.from_numpy(np.where(rng.random((b, w)) < 0.5, 0.0, -0.0
                                                          ).astype(np.float32)).to(dev),
                "ascending": torch.arange(w, device=dev, dtype=torch.float32).repeat(b, 1),
                "descending": -torch.arange(w, device=dev, dtype=torch.float32).repeat(b, 1)}
        m = masks(w)
        for kind, scores in rows.items():
            for live_name, live in m.items():
                for k in TOPK_KS:
                    if k <= w:
                        check(f"{kind} [{b} x {w}] live={live_name}", scores, k, live)
    torch.cuda.synchronize()
    say(f"topk_select: {out['checks']} checks, {len(out['failed'])} failed "
        f"({time.perf_counter() - t0:.1f} s)")

    # A captured BruteForce plan: one launch pair a replay; the same bytes
    # as the sort path's eager stages (``fits`` refusing every row).
    small.delete(small.ids[::9])
    searcher = small.searcher(k=10)
    searcher.warmup(64)
    (graph,) = small.backend.graphs.values()
    tally = graph.tally.get(kernel, 0)
    qs = queries_from_corpus(corpus, SEED + 2, 64 * BATCHES)
    kernel.launches = 0
    got = [searcher(qs[64 * i: 64 * (i + 1)]) for i in range(BATCHES)]
    launches = kernel.launches
    fits = sel.fits
    sel.fits = lambda scores, k: False    # every row back on the sort
    try:
        want = [search_eager(small, qs[64 * i: 64 * (i + 1)]) for i in range(BATCHES)]
    finally:
        sel.fits = fits
    same_results = all(same_result(a, b) for a, b in zip(got, want))
    out["plan"] = {"tally": tally, "launches": launches, "replays": BATCHES,
                   "same_as_sort": same_results}
    say(f"topk_select in a captured plan: tally {tally} a replay, {launches} launches over "
        f"{BATCHES} replays; results as the sort path's: {same_results}")
    expect(tally == 2 and launches == 2 * BATCHES,
           "topk_select: a captured plan's replay did not launch the select pair once")
    expect(same_results, "topk_select: a captured plan's results differ from the sort path's")
    del small, searcher, graph
    return out, {"1m": s1m, "45k": s45}


def topk_select_sweep(torch, np, dev, say, scores: dict) -> dict:
    """``--topk-select``'s slow part: the kernel against the sort at each of
    ``TOPK_SWEEP``'s widths (b 64 and 256, and its order on special values
    there) and of ``TOPK_NARROW_SWEEP``'s (width, k), and at ``TOPK_SHAPES``
    and ``TOPK_NARROW`` the kernel (with a half-live mask too), the masked
    sort, its plain version and ``torch.topk``, all in device time behind a
    spin."""
    from repro_torch.kernels import ref, topk_select as sel

    kernel = sel.topk_select_cuda
    rng = np.random.default_rng(SEED + 31)
    bits = np.array([b for _, b in SPECIAL_BITS], np.uint32)
    s45 = scores["45k"]
    out: dict = {"sweep": {}, "shapes": {}}
    for w in TOPK_SWEEP:
        sp = torch.from_numpy(bits[rng.integers(0, len(bits), size=(64, w))].view(np.float32)
                              ).to(dev)
        entry = {"order_as_sort": all(torch.equal(x, y) for x, y in zip(
            kernel(sp, 10)[1:], masked_sort_topk(sp, 10)[1:]))}
        for b in (64, 256):
            x = s45[:b, :w].contiguous()
            entry[f"b{b}"] = {"kernel_ms": device_ms(lambda: kernel(x, 10)),
                              "sort_ms": device_ms(lambda: masked_sort_topk(x, 10))}
        out["sweep"][w] = entry
        say(f"topk_select sweep w={w}: order as the sort's {entry['order_as_sort']}; "
            + "; ".join(f"b={b} kernel {entry[f'b{b}']['kernel_ms']:.4f} ms sort "
                        f"{entry[f'b{b}']['sort_ms']:.4f} ms" for b in (64, 256)))
    for w, k in TOPK_NARROW_SWEEP:
        entry = {}
        for b in (64, 256):
            x = s45[:b, :w].contiguous()
            entry[f"b{b}"] = {"kernel_ms": device_ms(lambda: kernel(x, k)),
                              "sort_ms": device_ms(lambda: masked_sort_topk(x, k))}
        out["sweep"][f"{w}k{k}"] = entry
        say(f"topk_select sweep w={w} k={k}: " + "; ".join(
            f"b={b} kernel {entry[f'b{b}']['kernel_ms']:.4f} ms sort "
            f"{entry[f'b{b}']['sort_ms']:.4f} ms" for b in (64, 256)))
    shapes = {(b, w, 10): scores["1m"] if w == BIG_N else s45[:b, :w] for b, w in TOPK_SHAPES}
    shapes.update({(b, w, k): s45[:b, :w].contiguous() for b, w, k in TOPK_NARROW})
    for (b, w, k), x in shapes.items():
        live = torch.from_numpy(rng.random(w) < 0.5).to(dev)
        chunk, chunks = sel.chunk_plan(b, w)
        entry = {
            "kernel_ms": device_ms(lambda: kernel(x, k)),
            "kernel_live_ms": device_ms(lambda: kernel(x, k, live)),
            "sort_ms": device_ms(lambda: masked_sort_topk(x, k)),
            "sort_live_ms": device_ms(lambda: masked_sort_topk(x, k, live)),
            "plain_ms": device_ms(lambda: ref.topk_select_ref(x, k, live), calls=3, samples=3),
            "torch_topk_ms": device_ms(lambda: torch.topk(x, k, dim=-1)),
            "bound_ms": 1e3 * 4 * b * w / PEAK_BYTES_PER_S, "chunk": chunk, "chunks": chunks}
        out["shapes"][f"{b}x{w}k{k}"] = entry
        say(f"topk_select [{b} x {w}] k={k} (chunk {chunk}, {chunks} a row): kernel "
            f"{entry['kernel_ms']:.4f} ms (live {entry['kernel_live_ms']:.4f}), bound "
            f"{entry['bound_ms']:.4f} ms ({100 * entry['bound_ms'] / entry['kernel_ms']:.1f}%), "
            f"sort {entry['sort_ms']:.4f} ms (masked {entry['sort_live_ms']:.4f}), plain "
            f"{entry['plain_ms']:.4f} ms, torch.topk {entry['torch_topk_ms']:.4f} ms")
    return out


def topk_select_child(report_path: str) -> int:
    """``--topk-select PATH``: the card's line, the build of
    csrc/topk_select.cu (ptxas report), phase 3b's checks, then the sweep
    and the slow timings; the report to PATH; exit 1 when a check failed."""
    import numpy as np
    import torch

    from repro_torch.kernels import cuda_build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    say(smi)
    report: dict = {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    for name, info in cuda_build.build(["topk_select", "nibble_dot", "hadamard"]).items():
        say(f"build {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                say(f"  {line.strip()}")
    t0 = time.perf_counter()
    report["topk_select"], scores = topk_select_checks(torch, np, dev, say, expect)
    report["topk_select"].update(topk_select_sweep(torch, np, dev, say, scores))
    say(f"topk_select checks, sweep and timings: {time.perf_counter() - t0:.1f} s")
    report["failures"] = FAILURES
    Path(report_path).parent.mkdir(parents=True, exist_ok=True)
    Path(report_path).write_text(json.dumps(report, indent=2, default=str))
    return 1 if FAILURES else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the full report here")
    ap.add_argument("--parent-csrc", default=None,
                    help="a directory holding another commit's nibble_dot.cu, gather_dot.cu, "
                         "hadamard.cu and binary_dot.cu: build them, hold the full scans, the "
                         "butterfly and the proxies byte for byte against them and time the "
                         "kernels in turns with these")
    ap.add_argument("--phase11-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phase12-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phase13-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--topk-select", default=None, metavar="PATH",
                    help="run phase 3b (the top-k select against the stable sort) alone, "
                         "with its sweep of widths and timings, and write its report to PATH")
    args = ap.parse_args()
    faulthandler.enable()     # a crash in native code names its Python line
    if args.phase11_child:
        return determinism_child(args.phase11_child)
    if args.phase12_child:
        return zoo_child(args.phase12_child)
    if args.phase13_child:
        return train_child(args.phase13_child)
    if args.topk_select:
        return topk_select_child(args.topk_select)

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
                                     ops, ref, topk_select)
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
    # below (ROADMAP C, C1).
    cpu_model = next((line.split(":", 1)[1].strip() for line in
                      Path("/proc/cpuinfo").read_text().splitlines()
                      if line.startswith("model name")), "unknown")
    say(f"host CPU {cpu_model}, torch CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads, "
        f"MKL_CBWR={os.environ.get('MKL_CBWR')}")
    report: dict = {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                    "host_cpu": cpu_model, "mkl_cbwr": os.environ.get("MKL_CBWR")}

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build(["hadamard", "nibble_dot", "binary_dot", "gather_dot",
                              "topk_select"])
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

    # ---- 3b. the top-k select against the sort --------------------------------
    t_phase = time.perf_counter()
    report["topk_select"], topk_scores = topk_select_checks(torch, np, dev, say, expect)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 3b: {time.perf_counter() - t_phase:.1f} s")

    # ---- 4. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    corpus = embedding_corpus(SEED, N, DIM)
    queries = queries_from_corpus(corpus, SEED + 1, 64 * BATCHES)
    say(f"data: corpus {corpus.shape} queries {queries.shape} in "
        f"{time.perf_counter() - t0:.2f} s")

    # Every kernel's launch counter; each path runs between a reset and a read.
    counters = kernel_counters()

    def reset_counts() -> None:
        reset_launches(counters)

    def read_counts() -> dict:
        return read_launches(counters)

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
    expect(search_launches["topk_select"] > 0,
           "the top-k select was not launched on the main path")

    scores = np.concatenate([r[0] for r in results])
    ids = np.concatenate([r[1] for r in results])
    expect(scores.shape == (64 * BATCHES, 10) and np.isfinite(scores).all(),
           "search scores are not finite [b, 10]")
    expect(bool((ids < N).all()), "search returned a sentinel or out-of-range id")

    qt = torch.from_numpy(queries).to(dev)
    ct = torch.from_numpy(corpus).to(dev)
    exact = exact_topk(scoring.score_f32(qt, ct, "cosine"), 10)[1].cpu().numpy()
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
    f_exact = exact_topk(scoring.score_f32(torch.from_numpy(f_queries).to(dev),
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

    # The top-k select at the two search cells' shapes, k 10, on phase 3b's
    # program scores; its yardstick the stable sort it replaced.
    topk_timing = {}
    for label, tk in topk_scores.items():
        tk_rows, tk_width = tk.shape
        run = lambda: topk_select.topk_select_cuda(tk, 10)
        te = {"kernel": time_ms(run), "device_ms": device_ms(run),
              "plain": time_ms(lambda: ref.topk_select_ref(tk, 10), iters=20, warmup=1),
              "library": time_ms(lambda: exact_topk(tk, 10)),
              "bound_ms": 1e3 * 4 * tk_rows * tk_width / PEAK_BYTES_PER_S, "bound_by": "bytes",
              "shape": [tk_rows, tk_width]}
        topk_timing[label] = te
        say(f"time topk_select [{tk_rows} x {tk_width}] k=10: one launch "
            f"{te['kernel']['median']:.4f} ms, device {te['device_ms']:.4f} ms "
            f"({te['bound_ms'] / te['device_ms']:.1%} of the bound {te['bound_ms']:.4f} ms, "
            f"bytes); plain {te['plain']['median']:.4f} ms; "
            f"stable sort {te['library']['median']:.4f} ms")
    del topk_scores, tk
    torch.cuda.empty_cache()

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
        expect(tally["topk_select"] == 2,
               f"engine {label}: a replay did not launch the top-k select pair once")
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

    # ---- 8. HNSW and hybrid ------------------------------------------------------
    t_phase = time.perf_counter()
    report["hnsw_hybrid"] = hnsw_hybrid_phase(SimpleNamespace(
        torch=torch, np=np, dev=dev, corpus=corpus, queries=queries, expect=expect, say=say,
        reset_counts=reset_counts, read_counts=read_counts, counters=counters))
    torch.cuda.empty_cache()
    say(f"phase 8: {time.perf_counter() - t_phase:.1f} s")

    # ---- 9. autotune -----------------------------------------------------------------
    # 9c ran inside phase 8 on the 8a index; its report and launches join 9's.
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["autotune"] = autotune_phase(SimpleNamespace(
        torch=torch, np=np, dev=dev, corpus=corpus, queries=queries, expect=expect, say=say,
        reset_counts=reset_counts, read_counts=read_counts, smi=smi))
    report["autotune"]["hnsw"] = report["hnsw_hybrid"].pop("tune")
    report["autotune"]["launches"]["9c_sweep"] = report["autotune"]["hnsw"]["sweep"]["launches"]
    torch.cuda.empty_cache()
    say(f"phase 9 (a, b, d): {time.perf_counter() - t_phase:.1f} s")

    # ---- 10. sharded retrieval and the serving CLI ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["shard_serve"] = shard_serve_phase(SimpleNamespace(
        torch=torch, np=np, dev=dev, corpus=corpus, queries=queries, expect=expect,
        reset_counts=reset_counts, read_counts=read_counts, smi=smi))
    say(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    # ---- 11. the determinism audit and the full-width probe ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["determinism"] = determinism_phase(SimpleNamespace(expect=expect))
    say(f"phase 11: {time.perf_counter() - t_phase:.1f} s")

    # ---- 12. the model zoo's serving forwards ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["zoo"] = zoo_phase(SimpleNamespace(expect=expect))
    say(f"phase 12: {time.perf_counter() - t_phase:.1f} s")

    # ---- 13. training on the card ---------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["train"] = train_phase(SimpleNamespace(expect=expect))
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

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
    # The top-k select replaces no TPU kernel (the reference's lax.top_k is a
    # library op); it is bit-exact (phase 3b).  Its times at the 1M cell's
    # [256 x 1,000,000], at_45k the 45K cell's [512 x 45,000]; its launches
    # on phase 4's main path (build and searches), 4b's cascades, 4c's
    # precisions, each counted from 0.
    t1m, t45k = topk_timing["1m"], topk_timing["45k"]
    kernels.append({
        "name": "topk_select", "route": "cuda", "source": "src/repro_torch/csrc/topk_select.cu",
        "replaces": "none (lax.top_k, a library op)", "launches": launches["topk_select"],
        "launches_cascade": cascade_launches["topk_select"],
        "launches_precision": precision_launches["topk_select"], "max_abs_err": 0.0,
        "ms": t1m["kernel"]["median"], "device_ms": t1m["device_ms"],
        "plain_ms": t1m["plain"]["median"], "bound_ms": t1m["bound_ms"], "bound_by": "bytes",
        "library_ms": t1m["library"]["median"], "shape": t1m["shape"],
        "at_45k": {"ms": t45k["kernel"]["median"], "device_ms": t45k["device_ms"],
                   "plain_ms": t45k["plain"]["median"], "bound_ms": t45k["bound_ms"],
                   "library_ms": t45k["library"]["median"], "shape": t45k["shape"]}})
    # The launches of each kernel on phase 8's paths: HNSW (8a, both efs), its
    # lifecycle (8d), a 2-bit HNSW with an added segment, hybrid (8f, plain).
    for entry in kernels:
        entry["launches_phase8"] = {path: counts[entry["name"]] for path, counts in
                                    report["hnsw_hybrid"]["launches"].items()}
    # Phase 9's paths: each autotune sweep (9a IVF, 9b sign cascade, 9c HNSW,
    # 9d the benchmark shape) and the boosted where= searches of 9a and 9b.
    for entry in kernels:
        entry["launches_phase9"] = {path: counts[entry["name"]] for path, counts in
                                    sorted(report["autotune"]["launches"].items())}
    # Phase 10's paths: the sharded full scans and filtered searches on 1, 4
    # and 7 shards (10a), the sharded cascades (10a), the three CLI runs (10b).
    for entry in kernels:
        entry["launches_phase10"] = {path: counts[entry["name"]] for path, counts in
                                     report["shard_serve"]["launches"].items()}
    # Phase 11's runs, in its child process: the audit grid on the card (11a,
    # its searches, stage reruns, recapture pass and hazard self-test) and
    # the full-width probe (11b, flag off and on, builds included).
    for entry in kernels:
        entry["launches_phase11"] = {part: counts.get(entry["name"], 0) for part, counts in
                                     report["determinism"]["launches"].items()}
    # Phase 12's parts, in its child process: llama3.2-3b's prefill + decode
    # (12a, bf16), its bf16 and 4-bit caches (B2 in every 4-bit step), the
    # two-tower corpus encode and retrieval (12b: B2, then B1), the smoke
    # configs and the full-width LMs (12c).
    for entry in kernels:
        entry["launches_phase12"] = {part: counts.get(entry["name"], 0) for part, counts in
                                     report["zoo"]["launches"].items()}
    # Phase 13's parts, in its child process: llama3.2-3b's training steps
    # (13a), the restart runs and the f32 step (13b), the two-tower training,
    # its 1,000,000-item encode (B2) and retrievals (B2, B1) (13c), the smoke
    # steps and the launcher (13d).
    for entry in kernels:
        entry["launches_phase13"] = {part: counts.get(entry["name"], 0) for part, counts in
                                     report["train"]["launches"].items()}
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
