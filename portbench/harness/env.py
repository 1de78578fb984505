"""Where the benchmark runs: the checkout's paths, the program's cache
directories inside it, the process's age, and the import guard."""

from __future__ import annotations

import os
import sys
from pathlib import Path

#: The checkout's root: the directory that holds ``portbench/`` and ``src/``.
ROOT = Path(__file__).resolve().parents[2]
#: Where the program's CUDA libraries are built (``kernels/cuda_build.py``
#: fixes ``<root>/build``); the other caches go beside them.
CACHE_DIR = ROOT / "build"

#: Top-level module names that may not be loaded: JAX, its libraries and
#: the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup() -> None:
    """Put the program on the path and fix every cache inside the checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    root = str(ROOT)
    if root not in sys.path:
        sys.path.insert(0, root)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE_DIR / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def pin() -> list:
    """Keep this process on two fixed cores of those it may use (the third
    and fourth, away from the first, which often takes the interrupts): one
    for the serving loop, one for the CUDA driver's threads.  Steadier host
    timings, the same work."""
    cores = sorted(os.sched_getaffinity(0))
    chosen = cores[2:4] if len(cores) >= 4 else cores
    os.sched_setaffinity(0, chosen)
    return chosen


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat against
    /proc/uptime, 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, each compared whole
    (``repro_torch`` is not ``repro``)."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))
