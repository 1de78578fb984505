"""Retrieval serving launcher: the service layer as a batched offline loop
(counterpart of ``repro/launch/serve.py``).

The paper ships FastAPI/REST; in this offline runtime the same contract is a
pure function: token -> namespace -> collection -> top-k.  This CLI builds
(or loads) a .mvec index and serves deterministic batched query traffic
through the query-execution engine (DESIGN.md §7): the serving loop holds a
bound handle

    search = reg.searcher(token, "default", k=10)   # == index.searcher(k=10)
    search.warmup(batch_size)      # on the card: capture the plan's graph
    scores, ids = search(queries)  # every call: a plan-cache hit, a replay

so each phase runs one untimed warm-up batch (the plan's build and, on the
card, its CUDA graph capture) before the measured batches, and reports the
engine's plan-cache hits / misses / captures alongside QPS: the measured
number is serving throughput, not capture time.

    python -m repro_torch.launch.serve --n 50000 [--index hnsw]
    python -m repro_torch.launch.serve --load corpus.mvec
    python -m repro_torch.launch.serve --n 200000 --shard
    python -m repro_torch.launch.serve --n 20000 --mutate --compact
    python -m repro_torch.launch.serve --n 20000 --micro-batch 8
    python -m repro_torch.launch.serve --n 50000 --index ivf --autotune --recall-target 0.95
    python -m repro_torch.launch.serve --n 2000 --dim 64 --device cpu

Everything runs on the card (``--device cuda``, the default; no fallback:
without CUDA it raises) unless ``--device cpu`` asks for the kernels' plain
versions on the host.

--autotune runs the training-free autotuner (DESIGN.md §12) after build or
load: seeded sample queries drawn from the corpus are swept against an exact
full-scan oracle over the same quantized segments, and the cheapest knob
rung meeting --recall-target becomes the serving default (every phase report
prints the resolved knobs).  With --save the tuned knobs persist as the
.mvec v11 TUNE block and reload as defaults.

--shard serves the BruteForce scan through repro_torch.dist: the corpus is
split over every local device and each batch runs the per-shard scans and
the cross-shard merge (results identical to the single-device path).

--mutate exercises the segmented lifecycle (DESIGN.md §6) through the tenant
registry, the offline analogue of the paper's POST /add, DELETE /ids and
POST /compact routes: after the first query phase it add()s a delta batch,
delete()s a stride of ids and serves again (scans cover base + extra
segments, tombstones masked before the top-k); with --compact it rewrites
the live rows into one segment and serves a last phase.

--micro-batch R splits every batch into R requests served through the
engine's MicroBatcher: requests coalesce per (namespace, collection, k,
where, hybrid?) group and run as one bucketed plan call, with per-request
results identical to solo searches.

--filter-every N attaches a ``bucket = row % N`` metadata column at build
time and serves an extra phase with ``where=Eq("bucket", 0)`` (selectivity
1/N) through the compiled predicate stage (DESIGN.md §8): the predicate's
constants are graph inputs, so repeat filtered batches replay one graph.

Observability (DESIGN.md §9): every phase report is read back out of the
process-wide metrics registry;

--metrics-json PATH   write the registry snapshot (counters, gauges, per-stage
                      latency histograms with their bucket edges) as JSON on exit;
--metrics-prom PATH   the same snapshot in Prometheus text exposition;
--trace-sample N      trace every Nth served batch end to end and print the
                      span trees per phase.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from .. import obs
from ..core.api import MonaVec
from ..core.predicate import Eq
from ..core.tenancy import TenantRegistry
from ..data.synthetic import embedding_corpus, queries_from_corpus
from ..engine.batcher import MicroBatcher


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--index", default="bruteforce", choices=["bruteforce", "ivf", "hnsw"])
    ap.add_argument("--load", default=None, help="serve an existing .mvec file")
    ap.add_argument("--save", default=None)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--token", default=None, help="tenant token (standalone mode)")
    ap.add_argument("--mutate", action="store_true",
                    help="run the add/delete/compact lifecycle phases after "
                         "the initial query phase (DESIGN.md §6)")
    ap.add_argument("--add-n", type=int, default=None,
                    help="rows to add() in the mutation phase "
                         "(default: 10%% of the corpus)")
    ap.add_argument("--delete-every", type=int, default=17,
                    help="delete() every Nth id in the mutation phase")
    ap.add_argument("--compact", action="store_true",
                    help="compact() after the mutation phase and re-serve")
    ap.add_argument("--shard", action="store_true",
                    help="shard the corpus over all local devices (bruteforce)")
    ap.add_argument("--filter-every", type=int, default=0, metavar="N",
                    help="attach a bucket=row%%N metadata column and serve a "
                         "filtered phase with where=Eq('bucket', 0): "
                         "selectivity 1/N through the compiled predicate "
                         "stage (DESIGN.md §8)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot (DESIGN.md §9) "
                         "as JSON on exit")
    ap.add_argument("--metrics-prom", default=None, metavar="PATH",
                    help="write the metrics snapshot in Prometheus text "
                         "exposition format on exit")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="trace every Nth served batch and dump its span "
                         "tree (0 = off)")
    ap.add_argument("--micro-batch", type=int, default=0, metavar="R",
                    help="serve each batch as R coalesced requests through "
                         "the engine MicroBatcher (0 = direct searcher)")
    ap.add_argument("--coarse", default="off", choices=["off", "sign", "crumb"],
                    help="attach a binarized coarse code at build time "
                         "(DESIGN.md §11; persisted as .mvec v10 with --save; "
                         "with --load, derives codes for a pre-v10 file); "
                         "unlocks --rescore-mult")
    ap.add_argument("--rescore-mult", type=int, default=0, metavar="R",
                    help="serve through the binarized cascade: coarse-scan "
                         "all rows, rescore only the top R*k survivors with "
                         "the 4-bit kernel (0 = full scan; requires --coarse "
                         "or a v10 .mvec)")
    ap.add_argument("--autotune", action="store_true",
                    help="run the training-free autotuner (DESIGN.md §12) "
                         "after build/load: seeded sample queries vs an "
                         "exact oracle pick the cheapest backend knob "
                         "meeting --recall-target; the tuned knobs become "
                         "the serving defaults (persisted with --save as "
                         ".mvec v11)")
    ap.add_argument("--recall-target", type=float, default=0.95,
                    metavar="R", help="autotune recall@k target (default "
                    "0.95; requires --autotune)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the index lives and the kernels run: the CUDA "
                         "kernels on the card (default; raises without CUDA) or "
                         "their plain versions on the host")
    return ap


def _check(args: argparse.Namespace) -> None:
    """The flag conflicts, each before any index is built."""
    if args.shard and not args.load and args.index != "bruteforce":
        raise SystemExit("--shard requires --index bruteforce "
                         "(or a bruteforce .mvec via --load)")
    if args.shard and args.mutate:
        # A ShardedMonaVec is a static row partition; mutate the unsharded
        # index, compact, then shard the result.
        raise SystemExit("--mutate does not apply to --shard (compact first)")
    if args.coarse != "off" and not args.load and args.index != "bruteforce":
        raise SystemExit("--coarse requires --index bruteforce")
    if args.rescore_mult and args.coarse == "off" and not args.load:
        raise SystemExit("--rescore-mult requires --coarse sign|crumb "
                         "(or a v10 .mvec via --load)")
    if args.rescore_mult and args.micro_batch:
        # MicroBatcher groups by (namespace, collection, k, where); per-
        # request knobs would split its coalescing contract.
        raise SystemExit("--rescore-mult does not apply to --micro-batch")


def _open_index(args: argparse.Namespace):
    """(index, corpus or None): the loaded or freshly built index."""
    if args.load:
        index = MonaVec.load(args.load, device=args.device)
        print(f"[serve] loaded {args.load}: n={index.backend.enc.n} "
              f"metric={index.backend.enc.metric}")
        if args.filter_every and (index.meta is None or "bucket" not in
                                  index.meta.columns):
            raise SystemExit("--filter-every needs a 'bucket' metadata "
                             "column; the loaded .mvec has none (build one "
                             "with --filter-every --save)")
        if args.coarse != "off":
            try:
                index.enable_coarse(args.coarse)   # the same codes on a v10 file
            except TypeError as e:
                raise SystemExit(f"--coarse: {e}")
            print(f"[serve] coarse codes attached (kind={args.coarse})")
        if args.rescore_mult and index.backend.enc.ccodes is None:
            raise SystemExit("--rescore-mult: the loaded .mvec carries no "
                             "coarse codes; add --coarse sign|crumb to "
                             "derive them at load time")
        return index, None
    corpus = embedding_corpus(0, args.n, args.dim)
    kw = {"nlist": 128} if args.index == "ivf" else (
        {"m": 16, "ef_construction": 64} if args.index == "hnsw" else {})
    meta = ({"bucket": np.arange(args.n, dtype=np.int64) % args.filter_every}
            if args.filter_every else None)
    t0 = time.time()
    coarse = None if args.coarse == "off" else args.coarse
    index = MonaVec.build(corpus, metric="cosine", index=args.index, meta=meta,
                          coarse=coarse, device=args.device, **kw)
    print(f"[serve] built {args.index} over {args.n}x{args.dim} "
          f"in {time.time() - t0:.1f}s"
          + (f" (+ bucket metadata column, {args.filter_every} values)" if meta else "")
          + (f" (+ {coarse} coarse codes)" if coarse else ""))
    return index, corpus


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    _check(args)
    index, corpus = _open_index(args)

    if args.autotune:
        # Training-free knob selection (DESIGN.md §12): seeded corpus-drawn
        # sample queries vs an exact full-scan oracle over the same
        # quantized segments; the chosen knobs ride on index.tuned and
        # become the defaults of every phase below.
        t0 = time.time()
        index.autotune(recall_target=args.recall_target, k=args.k)
        tr = index.tuned
        print(f"[serve] autotune: knobs={tr.knobs or '{} (full scan)'} "
              f"met_target={tr.met_target} "
              f"(recall@{tr.k} >= {tr.recall_target}, "
              f"{tr.n_queries} sample queries, {time.time() - t0:.1f}s)"
              + (f"; boost curve over {len(tr.boost.points)} selectivity "
                 f"breakpoints" if tr.boost is not None else ""))

    if args.save and (not args.load or args.autotune):
        # A loaded index is saved again only when --autotune gave it new
        # knobs to persist (the v11 TUNE block); --mutate saves at the end.
        index.save(args.save)
        print(f"[serve] saved {args.save}")

    if args.shard:
        try:
            index = index.shard()
        except TypeError as e:
            raise SystemExit(f"--shard: {e}")
        print(f"[serve] sharded {index.n} rows over {index.mesh.size} local device(s) "
              f"(per-shard scans + cross-shard merge)")
        dim = index.enc.dim
    else:
        dim = index.backend.enc.dim

    reg = TenantRegistry()
    ns = reg.put(args.token, "default", index)
    print(f"[serve] namespace={ns!r}")

    batcher = MicroBatcher(reg) if args.micro_batch else None
    tracer = obs.Tracer(sample_every=args.trace_sample)

    def phase_queries(b: int) -> np.ndarray:
        if corpus is not None:
            return queries_from_corpus(corpus, 100 + b, args.batch_size)
        rng = np.random.RandomState(100 + b)
        return rng.randn(args.batch_size, dim).astype(np.float32)

    def serve_batch(search, q: np.ndarray, where=None) -> None:
        if batcher is not None:
            # Split the batch into R requests and let the engine coalesce
            # them back into one bucketed plan execution per group.
            parts = np.array_split(q, min(args.micro_batch, len(q)))
            tickets = [batcher.submit(args.token, "default", p, k=args.k, where=where)
                       for p in parts]
            batcher.flush()
            for t in tickets:
                t.result()
        else:
            search(q)

    def run_phase(label: str, where=None) -> None:
        # The serving loop holds one bound searcher per phase; mutation
        # phases pick up the index's new segment signature automatically.
        knobs = {"rescore_mult": args.rescore_mult} if args.rescore_mult else {}
        if args.shard:
            search = reg.get(args.token, "default").searcher(k=args.k, where=where, **knobs)
        else:
            search = reg.searcher(args.token, "default", k=args.k, where=where, **knobs)
        live_idx = reg.get(args.token, "default")
        if hasattr(live_idx, "resolved_knobs"):
            # The exact knobs this phase runs with, after tuned-default
            # resolution and the engine's clamps (DESIGN.md §12); a sharded
            # index resolves its tuned defaults per call instead.
            resolved = live_idx.resolved_knobs(args.k, **knobs)
            print(f"[serve] {label}: knobs={resolved or '{} (full scan)'}"
                  + (" (tuned)" if getattr(live_idx, "tuned", None) is not None else ""))
        # Untimed warm-up: the first batch of a phase builds the plan and,
        # on the card, captures its graph; the measured QPS must not hold it.
        serve_batch(search, phase_queries(0), where)
        # The phase report reads the shared metrics registry (DESIGN.md §9):
        # plan-cache counters and batcher coalescing, diffed over the
        # measured window; the same numbers --metrics-json exports.
        before = obs.registry().snapshot()
        total, t0 = 0, time.time()
        for b in range(args.batches):
            q = phase_queries(b)
            with tracer.maybe(f"batch:{label}", phase=label, batch=b, rows=len(q)):
                serve_batch(search, q, where)
            total += len(q)
        dt = time.time() - t0
        d = obs.counter_deltas(obs.registry().snapshot(), before)
        print(f"[serve] {label}: {total} queries in {dt:.2f}s -> "
              f"{total / dt:.0f} QPS "
              f"(deterministic: rerun reproduces identical ids)")
        line = (f"[serve] {label}: plan cache "
                f"hits={obs.counter_total(d, 'plan_cache.hits')} "
                f"misses={obs.counter_total(d, 'plan_cache.misses')} "
                f"captures={obs.counter_total(d, 'plan_cache.captures')} "
                f"evictions={obs.counter_total(d, 'plan_cache.evictions')} "
                f"(measured window, post-warm-up)")
        if batcher is not None:
            line += (f"; micro-batch: "
                     f"{obs.counter_total(d, 'batcher.requests')} requests "
                     f"-> {obs.counter_total(d, 'batcher.executions')} "
                     f"plan executions")
        print(line)
        for tr in tracer.drain():
            print(f"[trace] sampled span tree ({label}):")
            for ln in tr.render().splitlines():
                print(f"[trace]   {ln}")

    run_phase("static")

    if args.filter_every:
        # The filtered serving phase (DESIGN.md §8): the same plan cache;
        # the predicate is a mask stage of the plan and its constants are
        # inputs of the graph, so repeat filtered batches capture nothing.
        live = reg.get(args.token, "default")
        frac = float(np.mean(live.meta["bucket"].values == 0))
        print(f"[serve] filter: where=Eq('bucket', 0) selects "
              f"~{100.0 * frac:.1f}% of rows")
        run_phase("filtered", where=Eq("bucket", 0))

    if args.mutate:
        # The paper's service-layer mutation routes, as registry calls.
        live = reg.get(args.token, "default")
        add_n = args.add_n if args.add_n is not None else max(1, live.n_total // 10)
        rng = np.random.RandomState(7)
        delta = rng.randn(add_n, dim).astype(np.float32)
        delta_meta = ({"bucket": np.arange(add_n, dtype=np.int64) % args.filter_every}
                      if args.filter_every else None)
        t0 = time.time()
        new_ids = reg.add(args.token, "default", delta, meta=delta_meta)
        print(f"[serve] add: {len(new_ids)} rows quantized into segment "
              f"ordinal {live.mut.next_ordinal - 1} in {time.time() - t0:.2f}s")
        victims = live.ids[::args.delete_every]
        n_del = reg.delete(args.token, "default", victims)
        print(f"[serve] delete: {n_del} rows tombstoned "
              f"(live {live.n_live}/{live.n_total})")
        run_phase("mutated")
        if args.compact:
            t0 = time.time()
            reclaimed = reg.compact(args.token, "default")
            print(f"[serve] compact: reclaimed {reclaimed} rows into one "
                  f"segment in {time.time() - t0:.2f}s")
            run_phase("compacted")
        if args.save:
            live.save(args.save)
            print(f"[serve] saved mutated index to {args.save} "
                  f"(multi-segment layout)" if not live.mut.is_static
                  else f"[serve] saved {args.save}")

    # The final observability export (DESIGN.md §9): the whole run's
    # registry, as JSON and/or Prometheus text.
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(obs.registry().snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[serve] wrote metrics snapshot to {args.metrics_json}")
    if args.metrics_prom:
        with open(args.metrics_prom, "w") as f:
            f.write(obs.registry().to_prometheus())
        print(f"[serve] wrote Prometheus exposition to {args.metrics_prom}")


if __name__ == "__main__":
    main()
