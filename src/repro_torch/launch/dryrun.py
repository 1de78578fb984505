"""The dry-run on meta tensors: build every (arch x shape x mesh) cell and
count it, with no device (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder devices.
Here a cell (``dist.steps.build_cell``) holds the port's step and its
arguments on ``torch.device("meta")``, which hold shapes and no data, so a
full-width step runs on the CPU in seconds and allocates nothing.  Per cell
this records, in one JSON named as the reference names it:

* ``model_flops``: the reference's analytic term (global batch);
* ``counted_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over one
  call of the step on meta (matmuls, convolutions and attention only, as
  it counts).  Where a kernel stands on the path (``counted_flops_by``
  names it) the count is that of the kernel's plain version, whose work
  differs from the kernel's: the Hadamard is a dense product there;
* ``bytes_per_device``: what one device of the production mesh holds of the
  parameters, the optimizer state, the batch and the cache, and their sum;
  each leaf's block is its dims over the sizes of the mesh axes its spec
  names, rounded up as XLA pads (``dist.sharding.shard_shape``).

Run as ``python -m repro_torch.launch.dryrun --arch fm --shape serve_p99
--out DIR``; ``--all --mesh both`` runs every cell.  Importing this module
changes no environment variable.  Not ported, because the port never
produces XLA HLO: ``--save-hlo``, ``parse_collectives`` and the record's
``hlo_*`` and ``collectives`` fields; the reference's ``heavy`` probe
variants, which bound XLA's compile time (``--all`` runs ``--variant``,
``baseline`` by default, everywhere); the memory twins (XLA's scheduler).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..dist import sharding as shd
from ..dist.steps import build_cell
from .mesh import make_production_mesh


def cell_bytes(cell, mesh) -> dict:
    """Bytes a device of ``mesh`` holds of each role of the cell's
    arguments, and their sum."""
    out = {"params": 0, "opt": 0, "batch": 0, "cache": 0}
    for role, structs in zip(cell.roles, cell.structs):
        if structs is not None:
            out[role] += shd.bytes_per_device(structs, mesh)
    out["total"] = sum(out.values())
    return out


def count_flops(cell) -> int:
    """FLOPs counted over one call of the cell's step on its meta arguments."""
    with FlopCounterMode(display=False) as counter:
        cell.fn(*cell.args)
    return int(counter.get_total_flops())


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, variant: str,
             out_dir: Path) -> dict:
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    arch = configs.get(arch_id)
    shape = next(s for s in arch.shapes if s.name == shape_name)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
           "ok": False, "n_devices": mesh.size}
    try:
        cell = build_cell(arch, shape, mesh, variant)
        rec["step"] = cell.step_name
        rec["model_flops"] = cell.model_flops
        rec["bytes_per_device"] = cell_bytes(cell, mesh)
        t_build = time.time()
        rec["build_s"] = round(t_build - t0, 1)
        rec["counted_flops"] = count_flops(cell)
        rec["counted_flops_by"] = "torch ops" + "".join(
            f"; the plain version of {k}" for k in cell.plain_kernels)
        rec["counted_over_model"] = rec["counted_flops"] / cell.model_flops
        rec["count_s"] = round(time.time() - t_build, 1)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 -- recorded, not swallowed
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)

    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch_id}__{shape_name}__{mesh_kind}__{variant}.json"
    out.write_text(json.dumps(rec, indent=1))
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:120]})"
    print(f"[dryrun] {arch_id} x {shape_name} x {mesh_kind} x {variant}: "
          f"{status} in {rec['total_s']}s", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true", help="run every registered cell")
    ap.add_argument("--include-extra", action="store_true",
                    help="include the monavec-scan supplementary cells")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(arch.arch_id, shape.name, mk, args.variant)
                for mk in meshes                 # finish the single-pod table first
                for arch, shape in configs.cells()
                if arch.family != "retrieval" or args.include_extra]
        print(f"[dryrun] {len(todo)} cells queued", flush=True)
        n_fail = 0
        for arch_id, shape_name, mk, v in todo:
            f = out_dir / f"{arch_id}__{shape_name}__{mk}__{v}.json"
            if args.skip_existing and f.exists() and json.loads(f.read_text()).get("ok"):
                print(f"[dryrun] skip existing {f.name}", flush=True)
                continue
            rec = run_cell(arch_id, shape_name, mk, v, out_dir)
            n_fail += 0 if rec["ok"] else 1
        print(f"[dryrun] done; {n_fail} failures", flush=True)
        raise SystemExit(1 if n_fail else 0)

    if not (args.arch and args.shape):
        raise SystemExit("--arch/--shape required without --all")
    recs = [run_cell(args.arch, args.shape, mk, args.variant, out_dir) for mk in meshes]
    raise SystemExit(0 if all(r["ok"] for r in recs) else 1)


if __name__ == "__main__":
    main()
