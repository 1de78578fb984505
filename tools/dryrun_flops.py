#!/usr/bin/env python3
"""Split the dry-run's counted FLOPs of the LM train cells by where they come
from, on meta tensors (no device).

    python3 tools/dryrun_flops.py [--arch ID ...] [--out PATH]

For each LM ``train_4k`` cell (``repro_torch.dist.steps.build_cell`` on the
single-pod mesh) this counts, with ``FlopCounterMode``, one call of the
cell's step as built (what ``launch.dryrun`` records as ``counted_flops``),
the same step with ``remat`` off, and the loss's forward alone, each over
the reference's analytic ``model_flops``; the forward's ratio is given x3
(``model_flops`` counts the backward as twice the forward).  Each count is
also split by op (``mm``, ``bmm``, ...).  So: forward x 3 against 1 is
what the analytic term leaves out or adds (MoE capacity, the MLA absorbed
products), the step without remat against forward x 3 the backward beyond
twice the forward, and the step against the step without remat what remat
recomputes.  Prints one line a count and a JSON object of all of them last.
A full-width deepseek-v3 step takes about a minute to count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, make_train_step  # noqa: E402


def _count(fn, *args) -> dict:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    by_op = {str(op).split(".")[1]: int(n) for op, n in counter.get_flop_counts()["Global"].items()}
    return {"total": int(counter.get_total_flops()), "by_op": by_op}


def split_cell(arch_id: str) -> dict:
    arch = configs.get(arch_id)
    shape = next(s for s in arch.shapes if s.kind == "train")
    mesh = make_production_mesh()
    out = {"arch": arch_id, "shape": shape.name}
    cell = steps.build_cell(arch, shape, mesh)
    out["model_flops"] = cell.model_flops
    out["step"] = _count(cell.fn, *cell.args)
    # The cell's config and its step (``build_cell``'s), with remat off.
    cfg = steps._lm_cfg(arch, mesh, unroll=True, depth=arch.make_config().n_layers,
                        kind="train")
    model, opt, tokens = cell.args
    no_remat = dataclasses.replace(cfg, remat=False)
    step = make_train_step(lambda p, b: tf.lm_loss(p, no_remat, b[0]),
                           AdamWConfig(moment_dtype="bfloat16" if cfg.moe else "float32"))
    out["step_no_remat"] = _count(step, model, opt, (tokens,))
    out["forward"] = _count(lambda m, t: tf.lm_loss(m, cfg, t), model, tokens)
    for key, scale in (("step", 1), ("step_no_remat", 1), ("forward", 3)):
        out[key]["over_model"] = scale * out[key]["total"] / cell.model_flops
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", nargs="*", default=None, help="LM arch ids (default: all)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    archs = args.arch or [a for a, arch in configs.all_archs().items() if arch.family == "lm"]
    results = []
    for arch_id in archs:
        t0 = time.time()
        r = split_cell(arch_id)
        r["seconds"] = round(time.time() - t0, 1)
        results.append(r)
        print(f"{arch_id}: step {r['step']['over_model']:.4f}, no remat "
              f"{r['step_no_remat']['over_model']:.4f}, forward x3 "
              f"{r['forward']['over_model']:.4f} of model_flops ({r['seconds']} s)", flush=True)
    line = json.dumps({"lm_train_flops": results})
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
