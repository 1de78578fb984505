"""The 4-bit full scan: CUDA kernel wrapper.

Counterpart of ``repro/kernels/nibble_dot.py`` (``nibble_dot_raw``): raw f32
scores ``[b, n] = <q_rot, deq(packed)>`` of rotated queries against a packed
4-bit corpus.  The kernel is ``csrc/nibble_dot.cu``; its plain version is
``kernels.ref.nibble_dot_ref``, and ``kernels.ops.nibble_score_raw`` picks
between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import lloydmax
from . import cuda_build


@functools.lru_cache(maxsize=8)
def _lut(device: torch.device) -> torch.Tensor:
    return torch.tensor(lloydmax.CENTROIDS_4BIT, device=device)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("nibble_dot")
    lib.nibble_dot.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.nibble_dot.restype = ctypes.c_int
    return lib


def nibble_dot_cuda(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """[n, d'/2] uint8 codes, [b, d'] f32 rotated queries -> [b, n] f32 raw scores."""
    if not (packed.is_cuda and q_rot.device == packed.device):
        raise ValueError(f"nibble_dot_cuda needs both tensors on one CUDA device, got "
                         f"{packed.device} and {q_rot.device}")
    if packed.dtype != torch.uint8 or q_rot.dtype != torch.float32:
        raise ValueError(f"nibble_dot_cuda takes uint8 codes and f32 queries, got "
                         f"{packed.dtype} and {q_rot.dtype}")
    if packed.dim() != 2 or q_rot.dim() != 2 or q_rot.shape[1] != 2 * packed.shape[1]:
        raise ValueError(f"shapes {tuple(packed.shape)} and {tuple(q_rot.shape)} are not "
                         f"[n, d'/2] and [b, d']")
    if not (packed.is_contiguous() and q_rot.is_contiguous()):
        raise ValueError("nibble_dot_cuda takes contiguous tensors")
    if packed.data_ptr() % 16 or q_rot.data_ptr() % 16:
        raise ValueError("nibble_dot_cuda needs 16-byte aligned tensors")
    (n, dk), b = packed.shape, q_rot.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=packed.device)
    lib = _lib()
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = lib.nibble_dot(packed.data_ptr(), q_rot.data_ptr(), _lut(packed.device).data_ptr(),
                        out.data_ptr(), b, n, 2 * dk, packed.device.index, stream)
    cuda_build.check(lib, "nibble_dot", rc)
    if b and n:
        nibble_dot_cuda.launches += 1
    return out


nibble_dot_cuda.launches = 0
