"""The binarized coarse-scan proxies: CUDA kernel wrappers.

Counterpart of ``repro/kernels/binary_dot.py``.  Both return int32 [b, n]:

* ``sign_hamming_cuda``: Hamming distances between packed sign bits
  (``sign_hamming_raw``);
* ``crumb_affinity_cuda``: the crumb affinity ``sum_i L(q_i) L(c_i)`` with
  ``L(c) = 2c - 3``, i.e. the four weighted AND+popcount terms of
  ``crumb_affinity_raw`` plus the rank-1 terms of ``_crumb_corrections``,
  which the kernel's epilogue adds.  Codes and queries carry the hi bit
  plane then the lo bit plane (``core.binary``).

Both kernels are ``csrc/binary_dot.cu``; their plain versions are
``kernels.ref.sign_hamming_ref`` and ``kernels.ref.crumb_affinity_ref``, and
``kernels.ops`` picks between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("binary_dot")
    for fn in (lib.sign_hamming, lib.crumb_affinity):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, codes: torch.Tensor, qcodes: torch.Tensor) -> None:
    if not (codes.is_cuda and qcodes.device == codes.device):
        raise ValueError(f"{name} needs both tensors on one CUDA device, got "
                         f"{codes.device} and {qcodes.device}")
    if codes.dtype != torch.uint8 or qcodes.dtype != torch.uint8:
        raise ValueError(f"{name} takes uint8 codes, got {codes.dtype} and {qcodes.dtype}")
    if codes.dim() != 2 or qcodes.dim() != 2 or qcodes.shape[1] != codes.shape[1]:
        raise ValueError(f"shapes {tuple(codes.shape)} and {tuple(qcodes.shape)} are not "
                         f"[n, bytes] and [b, bytes]")
    if not (codes.is_contiguous() and qcodes.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if codes.data_ptr() % 16 or qcodes.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned tensors")


def _launch(wrapper, fn_name: str, codes: torch.Tensor, qcodes: torch.Tensor,
            plane_bytes: int) -> torch.Tensor:
    """Run C entry point ``fn_name`` and count the launch on ``wrapper``."""
    (n, _), b = codes.shape, qcodes.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    lib = _lib()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = getattr(lib, fn_name)(codes.data_ptr(), qcodes.data_ptr(), out.data_ptr(), b, n,
                               plane_bytes, codes.device.index, stream)
    cuda_build.check(lib, "binary_dot", rc)
    if b and n:
        wrapper.launches += 1
    return out


def sign_hamming_cuda(cbits: torch.Tensor, qbits: torch.Tensor) -> torch.Tensor:
    """[n, d'/8] uint8 corpus sign bits, [b, d'/8] query sign bits -> [b, n] int32."""
    _check("sign_hamming_cuda", cbits, qbits)
    return _launch(sign_hamming_cuda, "sign_hamming", cbits, qbits, cbits.shape[1])


def crumb_affinity_cuda(ccodes: torch.Tensor, qplanes: torch.Tensor) -> torch.Tensor:
    """[n, d'/4] uint8 corpus crumb planes, [b, d'/4] query planes (hi || lo)
    -> [b, n] int32 affinities."""
    _check("crumb_affinity_cuda", ccodes, qplanes)
    if ccodes.shape[1] % 2:
        raise ValueError(f"crumb codes hold two planes, got {ccodes.shape[1]} bytes a row")
    return _launch(crumb_affinity_cuda, "crumb_affinity", ccodes, qplanes,
                   ccodes.shape[1] // 2)


sign_hamming_cuda.launches = 0
crumb_affinity_cuda.launches = 0
