"""The gathered 4-bit and 2-bit rescores: CUDA kernel wrappers.

Counterpart of ``repro/kernels/gather_dot.py`` (``gather_nibble_dot_raw``
and ``gather_crumb_dot_raw``): raw f32 scores
``[b, m] = <q_rot[q], deq(packed[cand[q, i]])>`` of each query against its
own candidate rows.  The kernels (``csrc/gather_dot.cu``) read the candidate
rows themselves, so the ``[b, m, bytes]`` gathered copy the reference makes
with ``jnp.take`` never exists.  A candidate outside ``[0, n)`` (the
cascade's -1) scores 0 and its row is never read.  Codes and queries may be
row-strided views, as for the full scans.  The plain versions are
``kernels.ref.gather_nibble_dot_ref`` and ``kernels.ref.gather_crumb_dot_ref``,
and ``kernels.ops.score_gathered_raw`` picks between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .nibble_dot import CODES_PER_BYTE, _lut, row_stride


#: Queries one launch takes: the C entry point's limit (the grid's y).
MAX_QUERIES = 65535

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
_ENTRY: dict = {}


def _entry(fn_name: str):
    """The C entry point, its ctypes signature set once when the library loads."""
    fn = _ENTRY.get(fn_name)
    if fn is None:
        lib = cuda_build.load("gather_dot")
        for name in ("gather_nibble_dot", "gather_crumb_dot"):
            entry = getattr(lib, name)
            entry.argtypes = _ARGTYPES
            entry.restype = ctypes.c_int
            _ENTRY[name] = entry
        fn = _ENTRY[fn_name]
    return fn


def _gather(wrapper, fn_name: str, bits: int, packed: torch.Tensor, q_rot: torch.Tensor,
            cand: torch.Tensor) -> torch.Tensor:
    # Every check reads each tensor's shape, stride and device once, and the
    # device as an index: the rescore is short enough on the card that this
    # host work is most of its cost.
    name = wrapper.__name__
    index = packed.get_device()
    if not (packed.is_cuda and q_rot.get_device() == index == cand.get_device()):
        raise ValueError(f"{name} needs its tensors on one CUDA device, got "
                         f"{packed.device}, {q_rot.device} and {cand.device}")
    if packed.dtype != torch.uint8 or q_rot.dtype != torch.float32 or cand.dtype != torch.int32:
        raise ValueError(f"{name} takes uint8 codes, f32 queries and int32 "
                         f"candidates, got {packed.dtype}, {q_rot.dtype} and {cand.dtype}")
    per = CODES_PER_BYTE[bits]
    p_shape, q_shape, c_shape = packed.shape, q_rot.shape, cand.shape
    if (len(p_shape) != 2 or len(q_shape) != 2 or len(c_shape) != 2 or p_shape[1] == 0
            or q_shape[1] != per * p_shape[1] or c_shape[0] != q_shape[0]):
        raise ValueError(f"shapes {tuple(p_shape)}, {tuple(q_shape)} and "
                         f"{tuple(c_shape)} are not [n, d'/{per}], [b, d'] and [b, m]")
    if not cand.is_contiguous():
        raise ValueError(f"{name} takes contiguous candidates")
    code_stride, q_stride = row_stride(name, packed), row_stride(name, q_rot)
    (n, dk), (b, m) = p_shape, c_shape
    out = q_rot.new_empty((b, m))
    if not m:
        return out
    entry, lut = _entry(fn_name), _lut(index, bits).data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(index)
    # A launch takes at most MAX_QUERIES queries (its grid's y); a score
    # depends only on its (query, row), so chunks give the same bytes.
    for lo in range(0, b, MAX_QUERIES):
        rows = min(MAX_QUERIES, b - lo)
        rc = entry(packed.data_ptr(), code_stride, q_rot.data_ptr() + 4 * lo * q_stride,
                   q_stride, cand.data_ptr() + 4 * lo * m, lut, out.data_ptr() + 4 * lo * m,
                   rows, m, n, per * dk, index, stream)
        if rc:
            cuda_build.check(cuda_build.load("gather_dot"), "gather_dot", rc)
        cuda_build.count_launch(wrapper)
    return out


def gather_nibble_dot_cuda(packed: torch.Tensor, q_rot: torch.Tensor,
                           cand: torch.Tensor) -> torch.Tensor:
    """[n, d'/2] uint8 codes, [b, d'] f32 rotated queries, [b, m] int32 rows
    -> [b, m] f32 raw scores."""
    return _gather(gather_nibble_dot_cuda, "gather_nibble_dot", 4, packed, q_rot, cand)


def gather_crumb_dot_cuda(packed: torch.Tensor, q_rot: torch.Tensor,
                          cand: torch.Tensor) -> torch.Tensor:
    """[n, d'/4] uint8 2-bit codes, [b, d'] f32 rotated queries, [b, m] int32
    rows -> [b, m] f32 raw scores."""
    return _gather(gather_crumb_dot_cuda, "gather_crumb_dot", 2, packed, q_rot, cand)


gather_nibble_dot_cuda.launches = 0
gather_crumb_dot_cuda.launches = 0
