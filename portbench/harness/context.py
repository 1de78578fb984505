"""What a run knows, handed to the traffic generator, the metric readers
and the comparison: the cell, the seed, the device, the program's modules
and state, the window's records and the device timers."""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from . import device as devmod
from .cells import Cell


def program():
    """The program's modules the benchmark drives (imported on first use)."""
    from repro_torch import MonaVec
    from repro_torch.core import binary, bruteforce, quantize, rhdh, scoring, standardize
    from repro_torch.core.tenancy import TenantRegistry
    from repro_torch.engine import plan
    from repro_torch.engine.batcher import MicroBatcher
    from repro_torch import obs

    return SimpleNamespace(MonaVec=MonaVec, TenantRegistry=TenantRegistry,
                           MicroBatcher=MicroBatcher, plan=plan, obs=obs, binary=binary,
                           bruteforce=bruteforce, quantize=quantize, rhdh=rhdh,
                           scoring=scoring, standardize=standardize)


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                          # perf_counter when the harness started
    age0: float                        # process age then (s)
    # Device timer override for the CPU rehearsals (never on the card).
    stage_timer: Optional[Callable[[Callable[[], object]], float]] = None
    port: SimpleNamespace = dataclasses.field(default_factory=program)
    setup_s: float = 0.0
    window_s: float = 0.0
    win: dict = dataclasses.field(default_factory=dict)     # the traffic's records
    state: dict = dataclasses.field(default_factory=dict)   # the program's state
    cache: dict = dataclasses.field(default_factory=dict)   # readers' shared inputs
    replays: Optional[devmod.ReplayTimer] = None
    profile_acts: Optional[list] = None                      # a profiled build's activity
    marks: list = dataclasses.field(default_factory=list)   # (set-up step, s since start)

    def mark(self, step: str) -> None:
        """Note the end of a set-up step (reported as ``setup_parts``)."""
        if self.on_card and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.marks.append((step, self.age0 + time.perf_counter() - self.t0))

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def mark_window_start(self) -> float:
        """Close the set-up: everything before this is ``setup_s``, and
        ``memory_peak_bytes`` is the peak from here on (the window's)."""
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        now = time.perf_counter()
        self.setup_s = self.age0 + (now - self.t0)
        self.marks.append(("warm-up", self.setup_s))
        return now

    def drop_cached(self) -> None:
        """Hand the allocator's cached blocks back to the card before the
        warm-up, so that the window's reserved peak is what its own work
        (the index, the captured graphs' pools, the builds) holds."""
        if self.on_card:
            torch.cuda.empty_cache()

    def build_index(self, x: torch.Tensor):
        """``MonaVec.build`` of ``x`` with the configuration's knobs."""
        cfg = self.cell.config
        return self.port.MonaVec.build(x, metric=cfg["metric"], bits=cfg["bits"],
                                       seed=cfg["rotation_seed"], device=self.device)

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def stage_ms(self, fn: Callable[[], object], reps: int = 20) -> float:
        """Device ms of one call of ``fn`` (CUDA events; the card only)."""
        if self.stage_timer is not None:
            return self.stage_timer(fn)
        return devmod.stage_ms(fn, reps=reps)

    def bound_ms(self, ops: float, nbytes: float) -> float:
        """The roofline bound at the card's published peaks (the CPU
        rehearsals, which measure nothing, take the H100's)."""
        kind = devmod.REHEARSAL_KIND if self.stage_timer is not None else None
        return 1e3 * devmod.bound_s(ops, nbytes, kind)
