"""`.mvec` single-file index format, version 6 (subset of
``repro/core/mvec_format.py``; paper §3.8).

A fixed 56-byte little-endian header, then length-prefixed blocks:

    0   MAGIC       4s   b"MVEC"
    4   VERSION     u32  6
    8   DIM         u32  input dimension d
    12  METRIC      u8   0=Cosine 1=Dot 2=L2
    13  BIT_WIDTH   u8
    14  INDEX_TYPE  u8   0=BruteForce 1=IvfFlat 2=HNSW
    15  PAD         u8
    16  COUNT       u64  rows
    24  SEED        u64  rotation seed
    32  N4_DIMS     u32
    36  INDEX_PARAMS 8B  (u32, u32)
    44  HAS_STD     u8   1 if the global standardization block follows
    45  (11 bytes)       zero in version 6

Blocks: STD_MEAN [f32 x dim] and STD_INV_STD [f32 x dim] (if HAS_STD), then
VECTORS [u8], IDS [u64], NORMS [f32] (each with a u64 byte length), then
INDEX_DATA (u64 length + bytes).  Every read is checked against the bytes
present, so a truncated or garbage-tailed file raises ValueError naming the
block.  Versions 7-11 are ROADMAP A3, A4, A6, A9 and A11.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Optional

import numpy as np
import torch

from . import quantize as qz
from .rhdh import next_pow2
from .standardize import COSINE, DOT, L2, GlobalStd

MAGIC = b"MVEC"
HEADER_LEN = 56
HEADER_FMT = "<4sIIBBBBQQIIIBB10s"
VERSION = 6
_METRIC_CODE = {COSINE: 0, DOT: 1, L2: 2}
_METRIC_NAME = {v: k for k, v in _METRIC_CODE.items()}
INDEX_BRUTEFORCE, INDEX_IVF, INDEX_HNSW = 0, 1, 2


def _write_array(buf: io.BytesIO, arr: np.ndarray) -> None:
    """Length-prefixed raw little-endian block."""
    raw = np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()
    buf.write(struct.pack("<Q", len(raw)))
    buf.write(raw)


class _Reader:
    """Validating block reader: every short read raises ValueError naming the
    block, so truncated or garbage files fail at the exact bad offset."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, nbytes: int, name: str) -> bytes:
        chunk = self.data[self.pos: self.pos + nbytes]
        if len(chunk) != nbytes:
            raise ValueError(
                f".mvec truncated in block {name!r}: need {nbytes} bytes at "
                f"offset {self.pos}, only {len(chunk)} available")
        self.pos += nbytes
        return chunk

    def u64(self, name: str) -> int:
        return struct.unpack("<Q", self.take(8, name))[0]

    def array(self, dtype, name: str, count: Optional[int] = None) -> np.ndarray:
        nbytes = self.u64(f"{name} length")
        dt = np.dtype(dtype).newbyteorder("<")
        if nbytes % dt.itemsize:
            raise ValueError(f".mvec corrupt block {name!r}: {nbytes} bytes is not a "
                             f"multiple of itemsize {dt.itemsize}")
        arr = np.frombuffer(self.take(nbytes, name), dtype=dt)
        if count is not None and arr.size != count:
            raise ValueError(f".mvec corrupt block {name!r}: expected {count} elements, "
                             f"found {arr.size}")
        return arr

    def expect_eof(self) -> None:
        extra = len(self.data) - self.pos
        if extra:
            raise ValueError(f".mvec garbage tail: {extra} unexpected bytes after the "
                             f"final block (offset {self.pos})")


@dataclasses.dataclass
class MvecFile:
    enc: qz.Encoded
    ids: np.ndarray
    index_type: int
    index_param: int = 0
    index_data: Optional[bytes] = None
    index_param2: int = 0


def save(path: str, f: MvecFile) -> None:
    enc = f.enc
    has_std = enc.std is not None
    header = struct.pack(
        HEADER_FMT, MAGIC, VERSION, enc.dim,
        _METRIC_CODE[enc.metric], enc.bits, f.index_type, 0,
        enc.n, enc.seed & 0xFFFFFFFFFFFFFFFF,
        enc.n4_dims, f.index_param, f.index_param2,
        1 if has_std else 0, 0, b"\x00" * 10,
    )
    buf = io.BytesIO()
    buf.write(header)
    if has_std:
        # Scalar globals replicated across dim (the format field is [f32 x dim]).
        _write_array(buf, np.full(enc.dim, enc.std.mean, dtype=np.float32))
        _write_array(buf, np.full(enc.dim, enc.std.inv_std, dtype=np.float32))
    _write_array(buf, enc.packed.cpu().numpy().astype(np.uint8))
    _write_array(buf, np.asarray(f.ids, dtype=np.uint64))
    _write_array(buf, enc.qnorms.cpu().numpy().astype(np.float32))
    blob = f.index_data or b""
    buf.write(struct.pack("<Q", len(blob)))
    buf.write(blob)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


def load(path: str, device: torch.device | str = "cpu") -> MvecFile:
    """Parse a version-6 file; the codes and norms land on ``device``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < HEADER_LEN:
        raise ValueError(f".mvec truncated in block 'header': need {HEADER_LEN} bytes, "
                         f"only {len(data)} available")
    (magic, version, dim, metric_c, bits, index_type, _pad, count, seed, n4_dims,
     index_param, param2, has_std, _has_perm, _tail) = struct.unpack(
        HEADER_FMT, data[:HEADER_LEN])
    if magic != MAGIC:
        raise ValueError(f"not a .mvec file (magic={magic!r})")
    if version != VERSION:
        raise ValueError(
            f"unsupported .mvec version {version}: the port reads version 6 only "
            f"(versions 7-11 are ROADMAP A3, A4, A6, A9, A11)")
    if metric_c not in _METRIC_NAME:
        raise ValueError(f".mvec corrupt header: unknown metric code {metric_c}")
    qz._require_4bit(bits)
    rd = _Reader(data, HEADER_LEN)
    std = None
    if has_std:
        mean = rd.array(np.float32, "std_mean", count=dim)
        inv = rd.array(np.float32, "std_inv_std", count=dim)
        std = GlobalStd(mean=float(mean[0]), inv_std=float(inv[0]))
    dim_pad = next_pow2(dim)
    bytes_per = dim_pad // 2
    packed = rd.array(np.uint8, "vectors")
    if packed.size != count * bytes_per:
        raise ValueError(f".mvec corrupt block 'vectors': expected {count * bytes_per} "
                         f"bytes ({count} rows x {bytes_per}), found {packed.size}")
    ids = rd.array(np.uint64, "ids", count=count)
    qnorms = rd.array(np.float32, "norms", count=count)
    blob_len = rd.u64("index_data length")
    blob = rd.take(blob_len, "index_data") if blob_len else None
    rd.expect_eof()
    enc = qz.Encoded(
        packed=torch.from_numpy(packed.reshape(count, bytes_per).copy()).to(device),
        qnorms=torch.from_numpy(qnorms.astype(np.float32)).to(device),
        seed=int(seed), metric=_METRIC_NAME[metric_c], bits=int(bits), dim=int(dim),
        dim_pad=dim_pad, n4_dims=int(n4_dims), std=std,
    )
    return MvecFile(enc=enc, ids=np.array(ids, dtype=np.uint64), index_type=int(index_type),
                    index_param=int(index_param), index_data=blob,
                    index_param2=int(param2))
