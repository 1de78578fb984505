"""Readings of the comparison's numbers, for setting the cells' limits: for
each seed, in one process, the cell's set-up and a short window, then the
numbers of the program's outputs and of the control (the reference at TF32
in the program's place) on the same inputs.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --out chiprun_out/readings.jsonl [--no-control]

One JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    env.setup()
    import torch

    from portbench.harness import runner

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    with open(args.out, "a") as f:
        for seed in [int(s) for s in args.seeds.split(",")]:
            t = time.perf_counter()
            ctx, kind = runner.start(args.workload, seed, args.seconds, False)
            out = runner.outputs(ctx, kind)
            line = {"workload": args.workload, "seed": seed,
                    "program": kind.compare(ctx, out)}
            if not args.no_control:
                line["control"] = kind.compare(ctx, out, control=True)
            line["seconds"] = time.perf_counter() - t
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
            del ctx, kind, out
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
