"""The rotate stage's Walsh-Hadamard transform: CUDA kernel and plain versions.

Counterpart of ``repro/kernels/hadamard.py`` (``fwht_pallas``).  Each
version computes ``H_{d'} (pad(x) * signs)`` over the last axis, the
quantizer-space RHDH rotation of every corpus row and every query:

* ``fwht_cuda``: the butterfly kernel of ``csrc/hadamard.cu``, pad and sign
  multiply fused into its load, any power-of-two d';
* ``signed_fwht_butterfly``: the same butterfly stage by stage in plain
  PyTorch, in the kernel's order, so it gives the kernel's bytes on the CPU
  and on the card (the kernel's byte oracle);
* ``signed_fwht_plain``: pad, multiply, then the Kronecker ``rhdh.fwht``,
  which is what the reference computes.

``signed_fwht`` picks by the tensor's device: the kernel for a CUDA tensor,
the Kronecker plain version for a CPU tensor, and the same plain version,
shapes only, for a meta tensor (the dry-run's cells).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.rhdh import fwht, pad_to_pow2
from . import cuda_build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY: dict = {}


def signed_fwht_plain(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    return fwht(pad_to_pow2(x, d_pad) * signs)


def signed_fwht_butterfly(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    """``H (pad(x) * signs)`` as the kernel sums it: x * signs, a +0.0 pad,
    then stages s = 0 .. log2(d') - 1, each pair (i, i + 2^s) -> (a + b, a - b)."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    y = pad_to_pow2(x * signs[:d], d_pad).reshape(-1, d_pad)
    h = 1
    while h < d_pad:
        pairs = y.reshape(-1, d_pad // (2 * h), 2, h)
        a, b = pairs[:, :, 0], pairs[:, :, 1]
        y = torch.stack((a + b, a - b), dim=2).reshape(-1, d_pad)
        h *= 2
    return y.reshape(lead + (d_pad,))


def _entry(fn_name: str):
    """The C entry point, its ctypes signature set once when the library loads."""
    fn = _ENTRY.get(fn_name)
    if fn is None:
        fn = getattr(cuda_build.load("hadamard"), fn_name)
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _ENTRY[fn_name] = fn
    return fn


def fwht_cuda(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    """[n, d] f32 CUDA rows -> [n, d'] f32 = H (pad(x) * signs)."""
    if x.dtype != torch.float32 or signs.dtype != torch.float32:
        raise ValueError(f"fwht_cuda takes f32, got {x.dtype} and {signs.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or not signs.is_contiguous():
        raise ValueError("fwht_cuda takes a contiguous [n, d] tensor and contiguous signs")
    n, d = x.shape
    if d_pad < 1 or d_pad & (d_pad - 1) or not d <= d_pad <= 1 << 30:
        raise ValueError(f"fwht_cuda takes a power-of-two d' with d={d} <= d' <= 2^30, "
                         f"got d'={d_pad}")
    if signs.shape != (d_pad,):
        raise ValueError(f"signs must have shape ({d_pad},), got {tuple(signs.shape)}")
    index = x.get_device()
    if not (x.is_cuda and signs.get_device() == index):
        raise ValueError(f"fwht_cuda needs x and signs on one CUDA device, got "
                         f"{x.device} and {signs.device}")
    out = x.new_empty((n, d_pad))
    rc = _entry("fwht_rows")(x.data_ptr(), signs.data_ptr(), out.data_ptr(), n, d, d_pad, index,
                  torch._C._cuda_getCurrentRawStream(index))
    if rc:
        cuda_build.check(cuda_build.load("hadamard"), "hadamard", rc)
    if n:
        cuda_build.count_launch(fwht_cuda)
    return out


fwht_cuda.launches = 0


def signed_fwht(x: torch.Tensor, signs: torch.Tensor, d_pad: int) -> torch.Tensor:
    """H (pad(x) * signs) over the last axis of x, on x's device: the kernel
    on CUDA, the plain version on the CPU and on meta (shapes only there)."""
    if x.is_cuda:
        lead = x.shape[:-1]
        y = fwht_cuda(x.reshape(-1, x.shape[-1]).contiguous(), signs, d_pad)
        return y.reshape(lead + (d_pad,))
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"no Hadamard path for device {x.device}")
    return signed_fwht_plain(x, signs, d_pad)
