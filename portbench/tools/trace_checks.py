"""One traced run of a search cell with the readers of the program's own
trace (``harness/spans.py``'s ``READERS``) added to its metrics, and the
trace held against the harness's clocks, round by round:

- ``stage_over_replay``: the ``device.<stage>`` spans of a round over the
  device time of its graph replay (the harness's CUDA events around
  ``CUDAGraph.replay``), min and max over the rounds;
- ``idle_err``: the idle time by cause, ``caller`` included, against the
  trace's extent less the union of its device spans (largest share);
- ``idle_vs_replays``: the same idle against the extent less the replay's
  and the copies' device time on the anchor's clock (largest share);
- ``anchor_err_us``: a round's anchor's error bound (largest, median, and
  the rounds at 20 us or more);
- ``submit_ms`` against the harness's clock around the round's submits;
- the traced window's ``search_qps`` and ``query_p95_ms``, and each
  round's replay device ms.

    python3 portbench/tools/trace_checks.py --workload <cell> --seed <n> \\
        --seconds <s> [--out chiprun_out/trace_checks.jsonl]

On a program without these spans the checks are left out and the rest is
reported; ``--bare`` adds no reader and no check (the traced run's own
cost, against an untraced run).  The last line of standard output is the
JSON record.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import env  # noqa: E402

AGE0 = env.process_age_s()


def _walk(span):
    yield span
    for c in span.children:
        yield from _walk(c)


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def round_checks(tr, replay) -> dict:
    """The checks of one round's trace ``tr``; ``replay`` its (start, end)
    CUDA events around the graph's replay."""
    spans = list(_walk(tr.root))
    device = [s for s in spans if s.kind == "device"]
    stages = sum(s.t_end - s.t_start for s in device
                 if s.name not in ("device.h2d", "device.d2h"))
    replay_s = replay[0].elapsed_time(replay[1]) / 1e3
    start, end = min(s.t_start for s in spans), tr.root.t_end
    busy = _union([(max(s.t_start, start), min(s.t_end, end)) for s in device])
    idle = sum(tr.idle.values())
    origin, t0 = tr.anchor
    r0 = t0 + origin.elapsed_time(replay[0]) / 1e3
    copies = [(s.t_start, s.t_end) for s in device if s.name in ("device.h2d", "device.d2h")]
    busy_replays = _union(copies + [(r0, r0 + replay_s)])
    submit = sum(s.t_end - s.t_start for s in spans if s.name == "batcher.submit")
    return {"stage_over_replay": stages / replay_s,
            "idle_err": abs(idle - (end - start - busy)) / max(end - start - busy, 1e-12),
            "idle_vs_replays": abs(idle - (end - start - busy_replays))
            / max(end - start - busy_replays, 1e-12),
            "anchor_err_us": tr.root.attrs["anchor_err_us"],
            "submit_s": submit, "idle_by_cause": dict(tr.idle)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--bare", action="store_true",
                    help="the cell's own metrics and the traced window's end-to-end ones only "
                         "(the traced run's cost: no reader or check added)")
    args = ap.parse_args(argv)
    env.setup()
    env.pin()
    import torch

    torch.set_num_threads(1)
    from repro_torch import obs

    from portbench.harness import cells, runner, spans
    from portbench.harness import device as devmod

    load, start, trace, timer = cells.load, runner.start, obs.trace, devmod.ReplayTimer
    per, ctxs, timers, sample = [], [], [], []

    def with_readers(name, overrides=None):
        c = load(name, overrides)
        extra = [] if args.bare else spans.READERS.get(name, [])
        return dataclasses.replace(c, per_layer=c.per_layer + extra)

    def starting(*a, **kw):
        ctx, kind = start(*a, **kw)
        ctxs.append(ctx)
        return ctx, kind

    class Timer(timer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    @contextlib.contextmanager
    def collecting(name, **attrs):
        # Each round's checks as it ends (the replay's events are reused by
        # nothing, the trace is dropped): the run keeps no trace alive.
        with trace(name, **attrs) as tr:
            yield tr
        if not args.bare and getattr(tr, "anchor", None) is not None and timers \
                and timers[-1].events:
            per.append(round_checks(tr, timers[-1].events[-1]))
            if len(per) == 10:
                sample.append(tr.render())

    cells.load, runner.start, obs.trace, devmod.ReplayTimer = \
        with_readers, starting, collecting, Timer
    result = runner.run_cell(args.workload, args.seed, args.seconds, True, device="cuda",
                             t0=T0, age0=AGE0)
    ctx = ctxs[0]
    rounds = ctx.win["rounds"]
    replays = ctx.replays.events
    rec = {"tag": args.tag, "workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(), "rounds": len(rounds),
           "replays": len(replays), "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"], "breakdown": result.get("breakdown")}
    for name in cells.load(args.workload).end_to_end:
        if name != "setup_s":
            rec["metrics"][name] = cells.reader(name).read(ctx)
    rec["replay_ms"] = statistics.median(s.elapsed_time(e) for s, e in replays)
    rec["harness_submit_ms"] = 1e3 * statistics.mean(r["submit"] for r in rounds)
    if per and len(per) == len(rounds) == len(replays):
        ratios = [p["stage_over_replay"] for p in per]
        causes: dict = {}
        for p in per:
            for k, v in p["idle_by_cause"].items():
                causes[k] = causes.get(k, 0.0) + v
        rec["checks"] = {
            "stage_over_replay_min": min(ratios), "stage_over_replay_max": max(ratios),
            "stage_over_replay_p1": sorted(ratios)[len(ratios) // 100],
            "rounds_under_0.9": sum(r < 0.9 for r in ratios),
            "idle_err_max": max(p["idle_err"] for p in per),
            "idle_vs_replays_max": max(p["idle_vs_replays"] for p in per),
            "idle_vs_replays_median": statistics.median(p["idle_vs_replays"] for p in per),
            "anchor_err_us_max": max(p["anchor_err_us"] for p in per),
            "anchor_err_us_median": statistics.median(p["anchor_err_us"] for p in per),
            "anchor_err_us_over_20": sum(p["anchor_err_us"] >= 20 for p in per),
            "submit_ms": 1e3 * statistics.mean(p["submit_s"] for p in per),
            "submit_below_harness": all(p["submit_s"] < r["submit"]
                                        for p, r in zip(per, rounds))}
        rec["idle_ms_by_cause"] = {k: 1e3 * v / len(per)
                                   for k, v in sorted(causes.items(), key=lambda kv: -kv[1])}
        rec["sample_trace"] = sample[0] if sample else None
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
