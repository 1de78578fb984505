"""Tiny CPU runs of the benchmark for its checks: every cell through the same
files, at a few thousand rows, with the kernels' plain versions (on the CPU
the program rotates with the plain Kronecker product, whose rounding is not
the card's butterfly's; the judge holds both to the same reference).
Device timings are not measured here: ``stage_timer`` calls the stage once
and reads 1 ms, so the readers' control flow runs and no number is a
measurement.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import env  # noqa: E402

env.setup()

CELLS = ("cohere1m.scan.c64x4", "agnews45k.scan.c64x8", "cohere1m.build",
         "cohere1m.sign32.c64x4")
SEARCH_SIZES = {"config": {"rows": 3000}, "traffic": {"pool": 256, "clients": 4,
                                                      "check_requests": 16}}
BUILD_SIZES = {"config": {"rows": 3000}}
#: Per-layer metrics that only the card reads (graph replays, the profiler).
CARD_ONLY = {"device_idle_pct.search", "device_idle_pct.host_bound",
             "device_idle_pct.build"}


def sizes(cell: str) -> dict:
    return BUILD_SIZES if cell.endswith(".build") else SEARCH_SIZES


def one_call_ms(fn) -> float:
    fn()
    return 1.0


def run(cell: str, trace: bool = False, seed: int = 2**31 + 17, seconds: float = 0.4) -> dict:
    """One tiny run's result object."""
    from portbench.harness import runner

    return runner.run_cell(cell, seed, seconds, trace, device="cpu",
                           overrides=sizes(cell), stage_timer=one_call_ms)


def readings(cell: str, control: bool, seed: int = 2**31 + 29) -> dict:
    """The comparison's numbers of one tiny run, or of the control."""
    from portbench.harness import runner

    ctx, kind = runner.start(cell, seed, 0.3, False, device="cpu", overrides=sizes(cell))
    return kind.compare(ctx, runner.outputs(ctx, kind), control=control)


def verdict(cell: str, nums: dict) -> bool:
    """``correct`` for these numbers under the cell's limits."""
    from portbench.harness import cells

    limits = cells.load(cell).limits
    return all(v <= limits[k] for k, v in nums.items())
