"""The rotate stage's Walsh-Hadamard transform: CUDA kernel and plain version.

Counterpart of ``repro/kernels/hadamard.py`` (``fwht_pallas``).  Both
versions compute ``H_{d'} (pad(x) * signs)`` over the last axis, the
quantizer-space RHDH rotation of every corpus row and every query:

* ``fwht_cuda``: the butterfly kernel of ``csrc/hadamard.cu``, pad and sign
  multiply fused into its load;
* ``signed_fwht_plain``: pad, multiply, then the Kronecker ``rhdh.fwht``.

``signed_fwht`` picks by the tensor's device: the kernel for a CUDA tensor,
the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.rhdh import fwht, pad_to_pow2
from . import cuda_build

#: Largest d' the kernel takes: one row of f32 in 128 KB of shared memory.
MAX_D_PAD = 32768


def signed_fwht_plain(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    return fwht(pad_to_pow2(x, d_pad) * signs)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("hadamard")
    lib.fwht_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fwht_rows.restype = ctypes.c_int
    return lib


def fwht_cuda(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    """[n, d] f32 CUDA rows -> [n, d'] f32 = H (pad(x) * signs)."""
    if not (x.is_cuda and signs.device == x.device):
        raise ValueError(f"fwht_cuda needs x and signs on one CUDA device, got "
                         f"{x.device} and {signs.device}")
    if x.dtype != torch.float32 or signs.dtype != torch.float32:
        raise ValueError(f"fwht_cuda takes f32, got {x.dtype} and {signs.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or not signs.is_contiguous():
        raise ValueError("fwht_cuda takes a contiguous [n, d] tensor and contiguous signs")
    n, d = x.shape
    if d_pad < 1 or d_pad & (d_pad - 1) or not d <= d_pad <= MAX_D_PAD:
        raise ValueError(f"fwht_cuda takes a power-of-two d' with d={d} <= d' <= "
                         f"{MAX_D_PAD}, got d'={d_pad}")
    if signs.shape != (d_pad,):
        raise ValueError(f"signs must have shape ({d_pad},), got {tuple(signs.shape)}")
    out = torch.empty((n, d_pad), dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fwht_rows(x.data_ptr(), signs.data_ptr(), out.data_ptr(), n, d, d_pad,
                       x.device.index, stream)
    cuda_build.check(lib, "hadamard", rc)
    if n:
        fwht_cuda.launches += 1
    return out


fwht_cuda.launches = 0


def signed_fwht(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    """H (pad(x) * signs) over the last axis of x, on x's device."""
    if x.is_cuda:
        lead = x.shape[:-1]
        y = fwht_cuda(x.reshape(-1, x.shape[-1]).contiguous(), signs, d_pad)
        return y.reshape(lead + (d_pad,))
    if x.device.type != "cpu":
        raise ValueError(f"no Hadamard path for device {x.device}")
    return signed_fwht_plain(x, signs, d_pad)
