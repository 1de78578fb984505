#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MonaVec on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json report.json]

Phases, in order (any failure exits non-zero and prints no result line):

1. check the card and print its ``nvidia-smi`` name and power limit;
2. build both CUDA kernels (src/repro_torch/csrc/) with nvcc, in parallel;
3. hold each kernel against its plain PyTorch version on the card, from
   numpy-seeded inputs: the Hadamard kernel at d' in {8, 16, 1024, 4096,
   32768} and at the main shape, the 4-bit scan at b in {1, 7, 64} x
   n in {1, 300, n} (d'=1024), at d'=16, and at n=1,000,000;
4. run the main path: ``MonaVec.build`` (cosine, BruteForce, 4-bit) over the
   seeded AG News stand-in, then 10 batches of 64 queries at k=10, reading
   the kernels' launch counters around it; recall@10 against exact f32
   cosine on the card; a repeated search must be byte-identical, and
   save -> load -> search equal; the encode's codes are counted against
   the plain (Kronecker) rotation on the card and a CPU encode;
5. time each kernel, its plain version and a one-call PyTorch yardstick
   with CUDA events (medians), beside the bound the card could reach; the
   end-to-end search rate and encode rate; and a torch.profiler breakdown
   of the search and build windows (device time by kernel, idle share).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth and non-tensor f32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# The main path's shapes: the paper's headline cell (AG News, 45K x 1024).
N = 45_000         # corpus rows
DIM = 1024         # embedding width
BIG_N = 1_000_000  # rows of the large scan check
SEED = 0           # data seed
BATCHES = 10       # query batches of 64 on the main path

FAILURES: list = []


def say(*parts) -> None:
    print(*parts, flush=True)


def expect(cond: bool, what: str) -> None:
    """Record a failed check; the run goes on so every check is reported,
    and the script exits non-zero at the end."""
    if not cond:
        FAILURES.append(what)
        say(f"FAIL: {what}")


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_window(torch, fn, label: str, top: int = 10) -> dict:
    """Device activity (kernels and copies) over one call of ``fn``, traced
    with torch.profiler: time by name, and the busy time as the union of the
    activity intervals over the traced window's wall time."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the full report here")
    args = ap.parse_args()

    import torch

    # ---- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import MonaVec
    from repro_torch.core import lloydmax, quantize as qz, rhdh, scoring, standardize
    from repro_torch.data.synthetic import embedding_corpus, queries_from_corpus
    from repro_torch.kernels import cuda_build, hadamard, ref
    from repro_torch.kernels.nibble_dot import nibble_dot_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report: dict = {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build(["hadamard", "nibble_dot"])
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        say(f"build {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                say(f"  {line.strip()}")
    say(f"build total: {build_s:.2f} s")
    report["build_s"] = build_s

    # ---- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED + 1)
    fwht_err = {}

    def check_fwht(n: int, d: int) -> float:
        d_pad = rhdh.next_pow2(d)
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        signs = rhdh.rademacher_signs(1234 + d, d_pad, dev)
        got = hadamard.fwht_cuda(x, signs, d_pad)
        want = hadamard.signed_fwht_plain(x, signs, d_pad)
        torch.cuda.synchronize()
        # Both sum the same +-x_i in another order: a per-row bound in ||x||_1.
        tol = 1e-5 * x.abs().sum(dim=1, keepdim=True) + 1e-6
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
        worst = float(err.max())
        say(f"fwht   n={n:>6} d={d:>5} d'={d_pad:>5}: max|err|={worst:.3e} "
            f"(tol 1e-5*|x|_1+1e-6) {'ok' if ok else 'MISMATCH'}")
        expect(ok, f"fwht kernel disagrees at n={n} d={d}")
        return worst

    for n, d in [(1000, 5), (1000, 16), (4096, 1000), (1024, 4096), (64, 32768)]:
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
        say(f"scan   b={b:>3} n={n:>7} d'={d_pad:>5}: max|err|={worst:.3e} "
            f"(tol 1e-5*sum|q*deq|+1e-6) {'ok' if ok else 'MISMATCH'}")
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
    report["kernel_checks"] = {"fwht_main_max_abs_err": fwht_err["main"],
                               "scan_main_max_abs_err": scan_err}

    # ---- 4. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    corpus = embedding_corpus(SEED, N, DIM)
    queries = queries_from_corpus(corpus, SEED + 1, 64 * BATCHES)
    say(f"data: corpus {corpus.shape} queries {queries.shape} in "
        f"{time.perf_counter() - t0:.2f} s")

    hadamard.fwht_cuda.launches = 0
    nibble_dot_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = MonaVec.build(corpus, metric="cosine")
    torch.cuda.synchronize()
    main_build_s = time.perf_counter() - t0
    build_launches = {"fwht": hadamard.fwht_cuda.launches,
                      "nibble_dot": nibble_dot_cuda.launches}
    results = []
    t0 = time.perf_counter()
    for i in range(BATCHES):
        results.append(idx.search(queries[64 * i: 64 * (i + 1)], k=10))
    main_search_s = time.perf_counter() - t0
    launches = {"fwht": hadamard.fwht_cuda.launches,
                "nibble_dot": nibble_dot_cuda.launches}
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

    # ---- 5. timing -----------------------------------------------------------
    # The 23 MB corpus stays in the 50 MB L2 between launches, as it does
    # between the searches of a server; the [45000, 1024] rotation does not.
    def time_ms(fn, iters: int = 50, warmup: int = 5) -> dict:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        # The highest percentile with at least ten samples beyond it.
        p = 1.0 - 10.0 / iters
        return {"median": times[iters // 2], "p": p, "p_ms": times[int(p * iters) - 1],
                "samples": iters}

    d_pad = enc.dim_pad
    b = 64
    q_rot = qz.encode_query(torch.from_numpy(queries[:b]).to(dev), enc).contiguous()
    deq_f32 = qz.decode(enc)
    t_scan = time_ms(lambda: nibble_dot_cuda(enc.packed, q_rot))
    t_scan_plain = time_ms(lambda: ref.nibble_dot_ref(enc.packed, q_rot), iters=20)
    t_scan_lib = time_ms(lambda: torch.matmul(q_rot, deq_f32.T))
    del deq_f32
    scan_bound, scan_by = bound_ms(
        nbytes=enc.n * d_pad / 2 + 4 * b * d_pad + 4 * b * enc.n,
        ops=2.0 * b * enc.n * d_pad)

    x = standardize.prepare(torch.from_numpy(corpus).to(dev), "cosine").contiguous()
    signs = rhdh.rademacher_signs(enc.seed, d_pad, dev)
    h_dense = torch.tensor(rhdh.hadamard_matrix(d_pad), device=dev)
    xs = (rhdh.pad_to_pow2(x, d_pad) * signs).contiguous()
    t_fwht = time_ms(lambda: hadamard.fwht_cuda(x, signs, d_pad))
    t_fwht_plain = time_ms(lambda: hadamard.signed_fwht_plain(x, signs, d_pad))
    t_fwht_lib = time_ms(lambda: torch.matmul(xs, h_dense))
    del xs, h_dense
    fwht_bound, fwht_by = bound_ms(
        nbytes=4.0 * x.shape[0] * (x.shape[1] + d_pad) + 4 * d_pad,
        ops=float(x.shape[0]) * d_pad * math.log2(d_pad))
    del x

    for name, t, tp, tl, bnd in (("scan", t_scan, t_scan_plain, t_scan_lib, scan_bound),
                                 ("fwht", t_fwht, t_fwht_plain, t_fwht_lib, fwht_bound)):
        say(f"time {name}: kernel {t['median']:.4f} ms (p{round(100 * t['p'])} "
            f"{t['p_ms']:.4f}, {t['samples']} samples), plain {tp['median']:.4f} ms, "
            f"library {tl['median']:.4f} ms, bound {bnd:.4f} ms")

    # End to end: search rate over timed batches of 64, and the encode rate.
    lat = []
    for i in range(100):
        qb = queries[64 * (i % BATCHES): 64 * (i % BATCHES + 1)]
        t0 = time.perf_counter()
        idx.search(qb, k=10)
        lat.append(time.perf_counter() - t0)
    lat.sort()
    qps = 64 * len(lat) / sum(lat)
    builds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MonaVec.build(corpus, metric="cosine")
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    encode_s = sorted(builds)[2]
    say(f"search: {qps:.1f} queries/s over {len(lat)} batches of 64; batch latency "
        f"median {1e3 * lat[50]:.3f} ms p90 {1e3 * lat[89]:.3f} ms")
    say(f"encode: {N / encode_s:.1f} rows/s ({N}x{DIM} from host numpy, "
        f"median of 5 builds: {encode_s:.4f} s)")
    report["timing"] = {
        "scan": {"kernel": t_scan, "plain": t_scan_plain, "library": t_scan_lib,
                 "bound_ms": scan_bound, "bound_by": scan_by},
        "fwht": {"kernel": t_fwht, "plain": t_fwht_plain, "library": t_fwht_lib,
                 "bound_ms": fwht_bound, "bound_by": fwht_by},
        "search_qps": qps, "search_batch_ms_median": 1e3 * lat[50],
        "search_batch_ms_p90": 1e3 * lat[89], "encode_rows_per_s": N / encode_s,
    }
    report["profile"] = {
        "search": profile_window(torch, lambda: [
            idx.search(queries[64 * i: 64 * (i + 1)], k=10) for i in range(BATCHES)],
            f"{BATCHES} searches of 64"),
        "build": profile_window(torch, lambda: MonaVec.build(corpus, metric="cosine"),
                                f"one build of {N}x{DIM}"),
    }
    # An estimate, not a measurement: the traced device time per batch over
    # the untraced median batch latency.
    busy_per_batch_ms = report["profile"]["search"]["device_busy_us"] / BATCHES / 1e3
    idle_est = max(0.0, 1.0 - busy_per_batch_ms / (1e3 * lat[50]))
    report["profile"]["search"]["idle_share_untraced_estimate"] = idle_est
    say(f"search idle share, estimated untraced: {idle_est:.3f} (traced device time "
        f"{busy_per_batch_ms:.4f} ms per batch over the untraced median batch latency "
        f"{1e3 * lat[50]:.4f} ms)")

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
    report["kernels"] = kernels
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
