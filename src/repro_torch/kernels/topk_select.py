"""The top-k select: the k best of each row of f32 scores, best first.

Computes what the stable descending sort cut to k gives (``core.scoring.topk``):
values highest first, among equal values the lower column first, with an
optional live mask over the columns (a dead column scores ``NEG``).  The
kernel is ``csrc/topk_select.cu`` (it replaces no TPU kernel: the reference
uses ``lax.top_k``); its plain version is ``kernels.ref.topk_select_ref``,
which repeats its arithmetic, and ``select`` picks between them by device.

Which rows it takes is decided by their shape alone (``fits``): 2-D f32
rows, ``k <= K_MAX``, no gradient wanted, and for k above ``SORT_K`` rows
wider than ``SORT_W``.  ``scoring.topk`` keeps the sort for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.allowlist import NEG
from . import cuda_build, ref

#: The largest k the kernel takes (the k best entries live across a warp's
#: lanes, two words a lane).
K_MAX = 64
#: Rows at most SORT_W wide keep the sort when k > SORT_K.  With one word a
#: lane (k <= 32) the kernel leads torch's stable sort, or trails it by at
#: most 0.002 ms, at every (width, k) measured, 8 to 1,000,000 columns;
#: above, each of the k best is a two-word insert across the warp, and
#: torch's one-launch sort of rows up to 4,096 wide leads: [64 x 96] k 64
#: (HNSW's beam at ef 64) 0.015 against the kernel's 0.024 ms, [64 x 4,096]
#: k 64 0.032 against 0.054 (NVIDIA H100; PERF.md §6).
SORT_K, SORT_W = 32, 4096
#: A warp's chunk of columns lies in [_MIN_CHUNK, _MAX_CHUNK], sized so a
#: launch has about _TARGET_UNITS (row, chunk) units: several per scheduler
#: of the card's 132 SMs, so no SM idles through the last wave.
_MIN_CHUNK, _MAX_CHUNK, _TARGET_UNITS = 1024, 8192, 4096
#: Columns a warp loads in one step (32 lanes x 4 x 16 bytes).
_STEP = 512

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_ENTRY: dict = {}


def _entry():
    """The C entry point, its ctypes signature set once when the library loads."""
    fn = _ENTRY.get("topk_select")
    if fn is None:
        fn = cuda_build.load("topk_select").topk_select
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY["topk_select"] = fn
    return fn


def fits(scores: torch.Tensor, k: int) -> bool:
    """Whether ``select`` takes these rows: 2-D f32 rows at least k wide
    (and under 2^31 - 1), 1 <= k <= ``K_MAX``, rows wider than ``SORT_W``
    where k > ``SORT_K``, no gradient wanted (the kernel has no backward)."""
    return (scores.dim() == 2 and scores.dtype == torch.float32 and 1 <= k <= K_MAX
            and k <= scores.shape[1] < 2 ** 31 - 1 and not scores.requires_grad
            and (k <= SORT_K or scores.shape[1] > SORT_W))


def chunk_plan(b: int, n: int) -> Tuple[int, int]:
    """(chunk, chunks): the columns of one warp's unit and the units a row."""
    want = -(-b * n // _TARGET_UNITS)
    chunk = min(_MAX_CHUNK, max(_MIN_CHUNK, -(-want // _STEP) * _STEP))
    return chunk, -(-n // chunk)


def select(scores: torch.Tensor, k: int,
           live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of each row of rows that ``fits``: the kernel for a CUDA
    tensor, the plain version for a CPU or meta one."""
    if scores.is_cuda:
        return topk_select_cuda(scores, k, live)
    return ref.topk_select_ref(scores, k, live)


def topk_select_cuda(scores: torch.Tensor, k: int,
                     live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, n] f32 scores (columns contiguous, any row stride), ``live`` [n]
    bool or None -> (vals [b, k] f32, idx [b, k] int64), best first."""
    name = "topk_select_cuda"
    if not scores.is_cuda or scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError(f"{name} takes 2-D f32 CUDA scores, got {scores.dtype} "
                         f"{tuple(scores.shape)} on {scores.device}")
    b, n = scores.shape
    if not (1 <= k <= K_MAX and k <= n < 2 ** 31 - 1):
        raise ValueError(f"{name} takes 1 <= k <= {K_MAX} and k <= n < 2^31 - 1, "
                         f"got k={k}, n={n}")
    if live is not None and (live.dtype != torch.bool or live.shape != (n,)
                             or live.device != scores.device):
        raise ValueError(f"{name} takes a [{n}] bool live mask on {scores.device}, got "
                         f"{live.dtype} {tuple(live.shape)} on {live.device}")
    if (n > 1 and scores.stride(1) != 1) or (b > 1 and scores.stride(0) < n):
        scores = scores.contiguous()    # columns apart, or rows overlapping (expanded)
    if live is not None:
        live = live.contiguous()
    row_stride = scores.stride(0) if b > 1 else n
    chunk, chunks = chunk_plan(b, n)
    index = scores.get_device()
    cand = torch.empty((b, chunks, k), dtype=torch.int64, device=scores.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=scores.device)
    rc = _entry()(scores.data_ptr(), row_stride, None if live is None else live.data_ptr(),
                  float(NEG), cand.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, n, k,
                  chunk, index, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        cuda_build.check(cuda_build.load("topk_select"), "topk_select", rc)
    if b:
        cuda_build.count_launch(topk_select_cuda)    # select_chunks
        cuda_build.count_launch(topk_select_cuda)    # merge_rows
    return vals, idx


topk_select_cuda.launches = 0
