"""The gathered 4-bit rescore: CUDA kernel wrapper.

Counterpart of ``repro/kernels/gather_dot.py`` (``gather_nibble_dot_raw``):
raw f32 scores ``[b, m] = <q_rot[q], deq(packed[cand[q, i]])>`` of each
query against its own candidate rows.  The kernel (``csrc/gather_dot.cu``)
reads the candidate rows itself, so the ``[b, m, d'/2]`` gathered copy the
reference makes with ``jnp.take`` never exists.  A candidate outside
``[0, n)`` (the cascade's -1) scores 0 and its row is never read.  The plain version is ``kernels.ref.gather_nibble_dot_ref``,
and ``kernels.ops.score_gathered_raw`` picks between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .nibble_dot import _lut


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gather_dot")
    lib.gather_nibble_dot.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.gather_nibble_dot.restype = ctypes.c_int
    return lib


def gather_nibble_dot_cuda(packed: torch.Tensor, q_rot: torch.Tensor,
                           cand: torch.Tensor) -> torch.Tensor:
    """[n, d'/2] uint8 codes, [b, d'] f32 rotated queries, [b, m] int32 rows
    -> [b, m] f32 raw scores."""
    if not (packed.is_cuda and q_rot.device == packed.device == cand.device):
        raise ValueError(f"gather_nibble_dot_cuda needs its tensors on one CUDA device, got "
                         f"{packed.device}, {q_rot.device} and {cand.device}")
    if packed.dtype != torch.uint8 or q_rot.dtype != torch.float32 or cand.dtype != torch.int32:
        raise ValueError(f"gather_nibble_dot_cuda takes uint8 codes, f32 queries and int32 "
                         f"candidates, got {packed.dtype}, {q_rot.dtype} and {cand.dtype}")
    if (packed.dim() != 2 or q_rot.dim() != 2 or cand.dim() != 2
            or q_rot.shape[1] != 2 * packed.shape[1] or cand.shape[0] != q_rot.shape[0]):
        raise ValueError(f"shapes {tuple(packed.shape)}, {tuple(q_rot.shape)} and "
                         f"{tuple(cand.shape)} are not [n, d'/2], [b, d'] and [b, m]")
    if not (packed.is_contiguous() and q_rot.is_contiguous() and cand.is_contiguous()):
        raise ValueError("gather_nibble_dot_cuda takes contiguous tensors")
    if packed.data_ptr() % 16 or q_rot.data_ptr() % 16:
        raise ValueError("gather_nibble_dot_cuda needs 16-byte aligned codes and queries")
    if q_rot.shape[0] > 65535:
        raise ValueError(f"gather_nibble_dot_cuda takes at most 65535 queries, got "
                         f"{q_rot.shape[0]}")
    (n, dk), (b, m) = packed.shape, cand.shape
    out = torch.empty((b, m), dtype=torch.float32, device=packed.device)
    lib = _lib()
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = lib.gather_nibble_dot(packed.data_ptr(), q_rot.data_ptr(), cand.data_ptr(),
                               _lut(packed.device).data_ptr(), out.data_ptr(), b, m, n,
                               2 * dk, packed.device.index, stream)
    cuda_build.check(lib, "gather_dot", rc)
    if b and m:
        gather_nibble_dot_cuda.launches += 1
    return out


gather_nibble_dot_cuda.launches = 0
