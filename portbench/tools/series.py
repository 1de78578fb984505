"""Runs one cell several times, each run a fresh process of the benchmark's
own command, and summarises each metric's median and spread (the distance
between the first and third quartile by ``statistics.quantiles(n=4)``, as a
share of the median).

    python3 portbench/tools/series.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 --trace 0 --out chiprun_out/series.jsonl

Each run's last line goes to ``--out`` with its seed, exit code and wall
time; the summary is printed as the last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="10")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", required=True)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    values: dict = {}
    bad = 0
    with open(args.out, "a") as f:
        for seed in args.seeds.split(","):
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                                   "--workload", args.workload, "--seed", seed,
                                   "--seconds", args.seconds, "--trace", args.trace],
                                  cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t
            lines = proc.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
            except (IndexError, ValueError):
                res = None
            rec = {"tag": args.tag, "workload": args.workload, "seed": int(seed),
                   "trace": int(args.trace), "rc": proc.returncode, "wall_s": wall,
                   "result": res}
            if res is None or proc.returncode:
                rec["stderr_tail"] = proc.stderr[-3000:]
                bad += 1
            elif not res["correct"]:
                bad += 1
            f.write(json.dumps(rec) + "\n")
            f.flush()
            short = None if res is None else {
                "correct": res["correct"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "checks": {k: v["value"] for k, v in res["checks"].items()}}
            print(json.dumps({"seed": int(seed), "rc": proc.returncode, "wall_s": round(wall, 1),
                              **({} if short is None else short)}), flush=True)
            if res is not None:
                for k, v in res["metrics"].items():
                    values.setdefault(k, []).append(v["value"])
            else:
                print(proc.stderr[-3000:], file=sys.stderr)
    summary = {k: {"median": statistics.median(v),
                   "spread": spread(v) if len(v) >= 2 else None, "n": len(v)}
               for k, v in values.items()}
    print(json.dumps({"workload": args.workload, "tag": args.tag, "bad": bad,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
