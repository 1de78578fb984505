"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` at the repository root (the hash is of
the source, so an edited kernel is rebuilt and a stale library never loads).
Nothing is compiled when a module is imported: the first wrapper call builds
what it needs, and ``build`` compiles several sources in parallel, one nvcc
process each.  Only sm_90a (Hopper) is targeted.

Each wrapper counts its kernel's launches on itself (``wrapper.launches``)
through ``count_launch``.  A launch recorded into a CUDA graph runs nothing
until the graph is replayed, so while a stream is capturing it goes to the
tally that ``capture_tally`` opened instead, and whoever replays the graph
adds that tally to the wrappers each replay: ``launches`` counts kernels that
ran on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_TALLY = threading.local()


def find_nvcc() -> Optional[str]:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str], *,
          clock: Callable[[], float] = time.perf_counter) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all at once.

    Returns {name: {"seconds": wall time by ``clock``, "log": nvcc's output
    (ptxas register and shared-memory report)}}; a source whose library
    exists reports 0 seconds and an empty log.  Raises RuntimeError if nvcc
    is missing or a compile fails.
    """
    names = list(names)
    todo = [n for n in names if not library_path(n).exists()]
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    if not todo:
        return report
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from csrc/ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = clock()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": clock() - t0, "log": log}
        if proc.returncode:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({err(code).decode()})")


@contextlib.contextmanager
def capture_tally() -> Iterator[Dict[object, int]]:
    """Open a tally {wrapper: launches} for the launches a CUDA graph capture
    on this thread records; the caller adds it to the wrappers per replay."""
    prev = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts = {}
    try:
        yield counts
    finally:
        _TALLY.counts = prev


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: on ``wrapper.launches`` when it ran
    now, on the open capture tally when a graph capture recorded it (a
    capture outside any tally is counted by no one)."""
    if torch.cuda.is_current_stream_capturing():
        counts = getattr(_TALLY, "counts", None)
        if counts is not None:
            counts[wrapper] = counts.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1
