"""Device timing: CUDA events around a stage, around each graph replay of a
window, and torch.profiler's activity over a window of eager work; the
table of published peaks.  Every function here needs the card and raises
without one: no CPU number is ever given a device metric's name."""

from __future__ import annotations

import contextlib
import math
import subprocess
from typing import Callable, List, Optional, Tuple

import torch

#: Published peaks by ``torch.cuda.get_device_name()``: f32 FMA rate off the
#: tensor cores (FLOP/s) and HBM bandwidth (bytes/s), NVIDIA's data sheet
#: (H100 SXM5, dense, at the 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}
#: The card whose peaks the CPU rehearsals' (unmeasured) shares are taken at.
REHEARSAL_KIND = "NVIDIA H100 80GB HBM3"


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA card; none is available")


def bound_s(ops: float, nbytes: float, kind: Optional[str] = None) -> float:
    """The least time the card (``kind``, default the one present) could
    take: operations at the f32 peak or bytes at the HBM peak, whichever is
    longer."""
    if kind is None:
        require_card()
        kind = torch.cuda.get_device_name()
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    p = PEAKS[kind]
    return max(ops / p["f32_flops"], nbytes / p["bytes_per_s"])


def stage_ms(fn: Callable[[], object], reps: int = 20, warm: int = 2) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, after ``warm`` calls."""
    require_card()
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class ReplayTimer:
    """Records CUDA events immediately around every ``CUDAGraph.replay`` while
    installed (the traced run's window); ``device_s`` sums their spans."""

    def __init__(self) -> None:
        self.events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def installed(self):
        require_card()
        original = torch.cuda.CUDAGraph.replay
        events = self.events

        def replay(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            original(graph)
            end.record()
            events.append((start, end))

        torch.cuda.CUDAGraph.replay = replay
        try:
            yield self
        finally:
            torch.cuda.CUDAGraph.replay = original

    def device_s(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


@contextlib.contextmanager
def profiled(host: bool = True):
    """torch.profiler over the block: device activity, and host operations
    unless ``host`` is False (a long window of many small launches).  Never
    around a CUDA graph replay: with torch 2.11 / CUDA 12.8 a replay under
    CUPTI tracing crashed the process."""
    require_card()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()


def device_activity(prof) -> list:
    """(start_us, end_us, name) of every device operation in a profile."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer")]


def busy_us(acts: list) -> float:
    """The union of the activity intervals, in us."""
    total, end = 0.0, -math.inf
    for start, stop, _ in sorted(acts):
        total += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return total


def top_ops(acts: list, top: int = 10) -> list:
    """[[name, seconds], ...] of the device operations that took most time."""
    by_name: dict = {}
    for start, stop, name in acts:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(acts: list, top: int = 10) -> list:
    """[[name, seconds], ...] of the longest stretches with no device
    operation, each named by the operation that ended it."""
    gaps, end = [], None
    for start, stop, name in sorted(acts):
        if end is not None and start > end:
            gaps.append([f"before {name[:80]}", (start - end) / 1e6])
        end = stop if end is None else max(end, stop)
    return sorted(gaps, key=lambda g: -g[1])[:top]


def power_limit_w() -> Optional[float]:
    """The card's power limit in W, as nvidia-smi reads it (None if it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
