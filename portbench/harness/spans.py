"""What the program's own trace of each traced round holds, for the metric
readers: the span totals by name that the traffic kind keeps per round
(``ctx.win["rounds"][i]["spans"]``, seconds), and the registry's
``trace.device_idle_us`` histograms.  Each returns None where the program
has no such span or histogram (a program older than its tracing)."""

from __future__ import annotations

from typing import Optional

#: The readers of the program's trace and the cells each is written for.
#: No cell lists them yet: a cell's metrics are its ``cells/<cell>.json``
#: and ``BENCHMARK.json``'s entries, which a benchmark change edits.
READERS = {
    "cohere1m.scan.c64x4": ["submit_ms.search", "queue_wait_ms.search",
                            "stage_scan_ms.search", "stage_finalize_ms.search",
                            "idle_in_program_ms.search"],
    "agnews45k.scan.c64x8": ["submit_ms.host_bound", "stage_finalize_ms.host_bound",
                             "idle_in_program_ms.host_bound"],
    "cohere1m.sign32.c64x4": ["submit_ms.search", "queue_wait_ms.search",
                              "stage_survivor_topk_ms.search", "idle_in_program_ms.search"],
}

IDLE_PREFIX = "trace.device_idle_us{"
CALLER = 'trace.device_idle_us{cause="caller"}'


def per_round_ms(ctx, name: str) -> Optional[float]:
    """Mean ms a traced round of the spans named ``name``."""
    rounds = ctx.win.get("rounds") or []
    if not any(name in r["spans"] for r in rounds):
        return None
    return 1e3 * sum(r["spans"].get(name, 0.0) for r in rounds) / len(rounds)


def per_request_ms(ctx, name: str) -> Optional[float]:
    """Mean ms a request of the spans named ``name`` (one a request)."""
    ms = per_round_ms(ctx, name)
    return None if ms is None else ms / ctx.cell.traffic["clients"]


def idle_in_program_ms(ctx) -> Optional[float]:
    """Mean ms a traced round in which the device ran nothing while a span
    of the program was open (every cause but ``caller``), from the
    program's ``trace.device_idle_us`` histograms: one process a run, so
    they hold the window's traced rounds alone."""
    rounds = ctx.win.get("rounds") or []
    hists = ctx.port.obs.registry().snapshot()["histograms"]
    idle = [h["sum"] for k, h in hists.items() if k.startswith(IDLE_PREFIX)]
    if not rounds or not idle:
        return None
    caller = hists[CALLER]["sum"] if CALLER in hists else 0.0
    return (sum(idle) - caller) / 1e3 / len(rounds)
