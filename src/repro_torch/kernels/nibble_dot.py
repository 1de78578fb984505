"""The 4-bit and 2-bit full scans: CUDA kernel wrappers.

Counterpart of ``repro/kernels/nibble_dot.py`` (``nibble_dot_raw`` and
``crumb_dot_raw``): raw f32 scores ``[b, n] = <q_rot, deq(packed)>`` of
rotated queries against packed 4-bit or 2-bit codes.  Both kernels are
``csrc/nibble_dot.cu``; their plain versions are ``kernels.ref.nibble_dot_ref``
and ``kernels.ref.crumb_dot_ref``, and ``kernels.ops`` picks between them by
device.

Codes and queries may be row-strided views (rows whose elements are
contiguous, any row stride), so the two blocks of a mixed corpus are
scanned as column slices of one tensor without a copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import lloydmax
from . import cuda_build

#: Codes per byte of each width the kernels take.
CODES_PER_BYTE = {4: 2, 2: 4}


@functools.lru_cache(maxsize=16)
def _lut(device: torch.device | int, bits: int) -> torch.Tensor:
    return torch.tensor(lloydmax.centroids(bits), device=device)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY: dict = {}


def _entry(fn_name: str):
    """The C entry point, its ctypes signature set once when the library loads."""
    fn = _ENTRY.get(fn_name)
    if fn is None:
        lib = cuda_build.load("nibble_dot")
        for name in ("nibble_dot", "crumb_dot"):
            entry = getattr(lib, name)
            entry.argtypes = _ARGTYPES
            entry.restype = ctypes.c_int
            _ENTRY[name] = entry
        fn = _ENTRY[fn_name]
    return fn


def row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride of a 2-D tensor whose rows are contiguous, the layout
    the kernels index; raises for any other layout."""
    shape, stride = t.shape, t.stride()
    if len(shape) != 2 or (shape[1] > 1 and stride[1] != 1):
        raise ValueError(f"{name} takes 2-D tensors with contiguous rows, got shape "
                         f"{tuple(shape)} and strides {stride}")
    return stride[0] if shape[0] > 1 else shape[1]   # one row: any stride will do


def _scan(wrapper, fn_name: str, bits: int, packed: torch.Tensor,
          q_rot: torch.Tensor) -> torch.Tensor:
    name = wrapper.__name__
    if not (packed.is_cuda and q_rot.device == packed.device):
        raise ValueError(f"{name} needs both tensors on one CUDA device, got "
                         f"{packed.device} and {q_rot.device}")
    if packed.dtype != torch.uint8 or q_rot.dtype != torch.float32:
        raise ValueError(f"{name} takes uint8 codes and f32 queries, got "
                         f"{packed.dtype} and {q_rot.dtype}")
    per = CODES_PER_BYTE[bits]
    if (packed.dim() != 2 or q_rot.dim() != 2 or packed.shape[1] == 0
            or q_rot.shape[1] != per * packed.shape[1]):
        raise ValueError(f"shapes {tuple(packed.shape)} and {tuple(q_rot.shape)} are not "
                         f"[n, d'/{per}] and [b, d'] with d' > 0")
    code_stride, q_stride = row_stride(name, packed), row_stride(name, q_rot)
    (n, dk), b = packed.shape, q_rot.shape[0]
    index = packed.get_device()
    out = q_rot.new_empty((b, n))
    rc = _entry(fn_name)(packed.data_ptr(), code_stride, q_rot.data_ptr(), q_stride,
                         _lut(index, bits).data_ptr(), out.data_ptr(), b, n, per * dk, index,
                         torch._C._cuda_getCurrentRawStream(index))
    if rc:
        cuda_build.check(cuda_build.load("nibble_dot"), "nibble_dot", rc)
    if b and n:
        cuda_build.count_launch(wrapper)
    return out


def nibble_dot_cuda(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """[n, d'/2] uint8 codes, [b, d'] f32 rotated queries -> [b, n] f32 raw scores."""
    return _scan(nibble_dot_cuda, "nibble_dot", 4, packed, q_rot)


def crumb_dot_cuda(packed: torch.Tensor, q_rot: torch.Tensor) -> torch.Tensor:
    """[n, d'/4] uint8 2-bit codes, [b, d'] f32 rotated queries -> [b, n] f32 raw scores."""
    return _scan(crumb_dot_cuda, "crumb_dot", 2, packed, q_rot)


nibble_dot_cuda.launches = 0
crumb_dot_cuda.launches = 0
