"""The binarized coarse-scan proxies: CUDA kernel wrappers.

Counterpart of ``repro/kernels/binary_dot.py``.  Both return int32 [b, n]:

* ``sign_hamming_cuda``: Hamming distances between packed sign bits
  (``sign_hamming_raw``);
* ``crumb_affinity_cuda``: the crumb affinity ``sum_i L(q_i) L(c_i)`` with
  ``L(c) = 2c - 3``, i.e. the four weighted AND+popcount terms of
  ``crumb_affinity_raw`` plus the rank-1 terms of ``_crumb_corrections``.
  Codes and queries carry the hi bit plane then the lo bit plane
  (``core.binary``).

Both kernels are one template in ``csrc/binary_dot.cu`` that runs the
AND+popcounts of the bit planes on the tensor cores (the Hamming distance
as ``pc(q) + pc(c) - 2 pc(q AND c)``); the wrappers launch it over chunks of
at most ``MAX_QUERIES`` queries.  Their plain versions are
``kernels.ref.sign_hamming_ref`` and ``kernels.ref.crumb_affinity_ref``, and
``kernels.ops`` picks between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

#: Queries one launch takes: the C entry points' limit (65,535 blocks of 64
#: queries on the grid's y).
MAX_QUERIES = 64 * 65535

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY: dict = {}


def _entry(fn_name: str):
    """The C entry point, its ctypes signature set once when the library loads."""
    fn = _ENTRY.get(fn_name)
    if fn is None:
        lib = cuda_build.load("binary_dot")
        for name in ("sign_hamming", "crumb_affinity"):
            entry = getattr(lib, name)
            entry.argtypes, entry.restype = _ARGTYPES, ctypes.c_int
            _ENTRY[name] = entry
        fn = _ENTRY[fn_name]
    return fn


def _launch(wrapper, fn_name: str, codes: torch.Tensor, qcodes: torch.Tensor,
            plane_bytes: int) -> torch.Tensor:
    """Check the operands, run C entry point ``fn_name`` over chunks of
    queries and count each launch on ``wrapper``."""
    name = wrapper.__name__
    index = codes.get_device()
    if not (codes.is_cuda and qcodes.get_device() == index):
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
    (n, width), b = codes.shape, qcodes.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    if not (b and n):
        return out
    entry, stream = _entry(fn_name), torch._C._cuda_getCurrentRawStream(index)
    # A launch takes at most MAX_QUERIES queries (its grid's y); a proxy
    # depends only on its (query, row), so chunks give the same bytes.
    for lo in range(0, b, MAX_QUERIES):
        rc = entry(codes.data_ptr(), qcodes.data_ptr() + lo * width,
                   out.data_ptr() + 4 * lo * n, min(MAX_QUERIES, b - lo), n, plane_bytes,
                   index, stream)
        if rc:
            cuda_build.check(cuda_build.load("binary_dot"), "binary_dot", rc)
        cuda_build.count_launch(wrapper)
    return out


def sign_hamming_cuda(cbits: torch.Tensor, qbits: torch.Tensor) -> torch.Tensor:
    """[n, d'/8] uint8 corpus sign bits, [b, d'/8] query sign bits -> [b, n] int32."""
    return _launch(sign_hamming_cuda, "sign_hamming", cbits, qbits, cbits.shape[-1])


def crumb_affinity_cuda(ccodes: torch.Tensor, qplanes: torch.Tensor) -> torch.Tensor:
    """[n, d'/4] uint8 corpus crumb planes, [b, d'/4] query planes (hi || lo)
    -> [b, n] int32 affinities."""
    if ccodes.shape[-1] % 2:
        raise ValueError(f"crumb codes hold two planes, got {ccodes.shape[-1]} bytes a row")
    return _launch(crumb_affinity_cuda, "crumb_affinity", ccodes, qplanes,
                   ccodes.shape[-1] // 2)


sign_hamming_cuda.launches = 0
crumb_affinity_cuda.launches = 0
