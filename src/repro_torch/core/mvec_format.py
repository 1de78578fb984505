"""`.mvec` single-file index format, versions 6, 7 and static 10 (subset of
``repro/core/mvec_format.py``; paper §3.8, DESIGN.md §2 and §11).

A fixed 56-byte little-endian header, then length-prefixed blocks:

    0   MAGIC       4s   b"MVEC"
    4   VERSION     u32  6, 7 (a permutation block) or 10 (coarse codes)
    8   DIM         u32  input dimension d
    12  METRIC      u8   0=Cosine 1=Dot 2=L2
    13  BIT_WIDTH   u8   2, 3 (mixed 4/2) or 4
    14  INDEX_TYPE  u8   0=BruteForce 1=IvfFlat 2=HNSW
    15  PAD         u8
    16  COUNT       u64  rows
    24  SEED        u64  rotation seed
    32  N4_DIMS     u32  4-bit dims of a mixed row
    36  INDEX_PARAMS 8B  (u32, u32)
    44  HAS_STD     u8   1 if the global standardization block follows
    45  HAS_PERM    u8   v8 and later: 1 if the PERM block follows (v7 says
                         so through VERSION; always 0 in v6 and v7)
    46  COARSE_KIND u8   v10: 1=sign 2=crumb (0 in versions 6 and 7)
    47  HAS_META    u8   v10: 0 (metadata columns are ROADMAP A6)
    48  (8 bytes)        zero

Blocks: STD_MEAN [f32 x dim] and STD_INV_STD [f32 x dim] (if HAS_STD), PERM
[i32 x d'] (v7, or v10 with HAS_PERM), then VECTORS [u8], IDS [u64], NORMS
[f32] (each with a u64 byte length), then INDEX_DATA (u64 length + bytes).
A row of VECTORS is d'/2 bytes (4-bit), d'/4 (2-bit), or N4_DIMS/2 +
(d'-N4_DIMS)/4 (mixed).  An index with coarse codes is written as version
10: the v6 body (with its PERM block if any), then the segment table of
version 8 with no extra segment (SEG_COUNT u32 = 0) and the base segment's
all-zero tombstone bitmap (u64 length + packbits bytes), then the CODE
block [u8, n x code_bytes].  Every read is checked against the bytes
present, so a truncated or garbage-tailed file raises ValueError naming the
block.  A file the port cannot represent raises NotImplementedError naming
the ROADMAP item: version 8 and a v10 file with extra segments or
tombstones (A4), version 9 and metadata columns (A6), version 11 (A11).
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Optional

import numpy as np
import torch

from . import quantize as qz
from .binary import code_bytes
from .rhdh import next_pow2
from .standardize import COSINE, DOT, L2, GlobalStd

MAGIC = b"MVEC"
HEADER_LEN = 56
HEADER_FMT = "<4sIIBBBBQQIIIBB10s"
VERSION = 6
VERSION_PERM = 7
VERSION_COARSE = 10
_COARSE_CODE = {"sign": 1, "crumb": 2}
_COARSE_NAME = {v: k for k, v in _COARSE_CODE.items()}
_UNPORTED_VERSION = {8: "A4: segments and tombstones", 9: "A6: metadata columns",
                     11: "A11: autotune results"}
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

    def u32(self, name: str) -> int:
        return struct.unpack("<I", self.take(4, name))[0]

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
    """Write static version 10 when ``f.enc`` carries coarse codes, else
    version 7 when it carries a permutation, else version 6."""
    enc = f.enc
    has_std = enc.std is not None
    has_codes = enc.ccodes is not None
    has_perm = enc.perm is not None
    version = VERSION_COARSE if has_codes else VERSION_PERM if has_perm else VERSION
    header = struct.pack(
        HEADER_FMT, MAGIC, version, enc.dim,
        _METRIC_CODE[enc.metric], enc.bits, f.index_type, 0,
        enc.n, enc.seed & 0xFFFFFFFFFFFFFFFF,
        enc.n4_dims, f.index_param, f.index_param2,
        1 if has_std else 0, 1 if (has_perm and version >= 8) else 0,
        bytes([_COARSE_CODE[enc.coarse] if has_codes else 0, 0]) + b"\x00" * 8,
    )
    buf = io.BytesIO()
    buf.write(header)
    if has_std:
        # Scalar globals replicated across dim (the format field is [f32 x dim]).
        _write_array(buf, np.full(enc.dim, enc.std.mean, dtype=np.float32))
        _write_array(buf, np.full(enc.dim, enc.std.inv_std, dtype=np.float32))
    if has_perm:
        _write_array(buf, enc.perm.astype(np.int32))
    _write_array(buf, enc.packed.cpu().numpy().astype(np.uint8))
    _write_array(buf, np.asarray(f.ids, dtype=np.uint64))
    _write_array(buf, enc.qnorms.cpu().numpy().astype(np.float32))
    blob = f.index_data or b""
    buf.write(struct.pack("<Q", len(blob)))
    buf.write(blob)
    if has_codes:
        buf.write(struct.pack("<I", 0))                       # no extra segment
        _write_array(buf, np.packbits(np.zeros(enc.n, dtype=bool)))   # no tombstone
        _write_array(buf, enc.ccodes.cpu().numpy().astype(np.uint8))
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


def _read_static_coarse(rd: _Reader, count: int, dim_pad: int, kind: str, *,
                        has_meta: bool) -> np.ndarray:
    """The v10 tail of a static index: an empty segment table, a clear
    tombstone bitmap and the CODE block [count, code_bytes] (uint8)."""
    if rd.u32("segment table"):
        raise NotImplementedError(".mvec extra segments are not ported yet "
                                  "(ROADMAP A4: segments and tombstones)")
    tombs = rd.array(np.uint8, "tombstones[0]", count=(count + 7) // 8)
    if tombs.any():
        raise NotImplementedError(".mvec tombstones are not ported yet "
                                  "(ROADMAP A4: segments and tombstones)")
    if has_meta:
        raise NotImplementedError(".mvec metadata columns are not ported yet "
                                  "(ROADMAP A6: metadata columns)")
    cb = code_bytes(dim_pad, kind)
    codes = rd.array(np.uint8, "coarse codes[0]", count=count * cb)
    return codes.reshape(count, cb).copy()


def load(path: str, device: torch.device | str = "cpu") -> MvecFile:
    """Parse a version-6, version-7 or static version-10 file; the codes,
    norms and coarse codes land on ``device``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < HEADER_LEN:
        raise ValueError(f".mvec truncated in block 'header': need {HEADER_LEN} bytes, "
                         f"only {len(data)} available")
    (magic, version, dim, metric_c, bits, index_type, _pad, count, seed, n4_dims,
     index_param, param2, has_std, has_perm, tail) = struct.unpack(
        HEADER_FMT, data[:HEADER_LEN])
    if magic != MAGIC:
        raise ValueError(f"not a .mvec file (magic={magic!r})")
    if version in _UNPORTED_VERSION:
        raise NotImplementedError(
            f".mvec version {version} is not ported yet (ROADMAP {_UNPORTED_VERSION[version]})"
            f"; the port reads versions 6 and 7 and static version 10")
    if version not in (VERSION, VERSION_PERM, VERSION_COARSE):
        raise ValueError(
            f"unsupported .mvec version {version}: the port reads versions 6, 7 and 10")
    if metric_c not in _METRIC_NAME:
        raise ValueError(f".mvec corrupt header: unknown metric code {metric_c}")
    if bits not in qz.BIT_WIDTHS:
        raise ValueError(f".mvec corrupt header: BIT_WIDTH {bits} is not one of "
                         f"{qz.BIT_WIDTHS}")
    if bits == 3 and not (n4_dims <= next_pow2(dim) and n4_dims % 4 == 0):
        raise ValueError(f".mvec corrupt header: N4_DIMS {n4_dims} is not a multiple of 4 "
                         f"in [0, {next_pow2(dim)}]")
    coarse = None
    if version == VERSION_COARSE:
        if tail[0] not in _COARSE_NAME:
            raise ValueError(f".mvec corrupt header: version 10 requires COARSE_KIND 1 "
                             f"(sign) or 2 (crumb), got {tail[0]}")
        coarse = _COARSE_NAME[tail[0]]
    rd = _Reader(data, HEADER_LEN)
    std = None
    if has_std:
        mean = rd.array(np.float32, "std_mean", count=dim)
        inv = rd.array(np.float32, "std_inv_std", count=dim)
        std = GlobalStd(mean=float(mean[0]), inv_std=float(inv[0]))
    dim_pad = next_pow2(dim)
    perm = None
    if version == VERSION_PERM or (version >= 8 and has_perm):
        perm = rd.array(np.int32, "perm", count=dim_pad)
        if not np.array_equal(np.sort(perm), np.arange(dim_pad)):
            raise ValueError(f".mvec corrupt block 'perm': not a permutation of "
                             f"range({dim_pad})")
    bytes_per = qz.bytes_per_vector(dim_pad, bits, n4_dims)
    packed = rd.array(np.uint8, "vectors")
    if packed.size != count * bytes_per:
        raise ValueError(f".mvec corrupt block 'vectors': expected {count * bytes_per} "
                         f"bytes ({count} rows x {bytes_per}), found {packed.size}")
    ids = rd.array(np.uint64, "ids", count=count)
    qnorms = rd.array(np.float32, "norms", count=count)
    blob_len = rd.u64("index_data length")
    blob = rd.take(blob_len, "index_data") if blob_len else None
    ccodes = None
    if coarse is not None:
        ccodes = _read_static_coarse(rd, count, dim_pad, coarse, has_meta=bool(tail[1]))
    rd.expect_eof()
    enc = qz.Encoded(
        packed=torch.from_numpy(packed.reshape(count, bytes_per).copy()).to(device),
        qnorms=torch.from_numpy(qnorms.astype(np.float32)).to(device),
        seed=int(seed), metric=_METRIC_NAME[metric_c], bits=int(bits), dim=int(dim),
        dim_pad=dim_pad, n4_dims=int(n4_dims), std=std, perm=perm, coarse=coarse,
        ccodes=None if ccodes is None else torch.from_numpy(ccodes).to(device),
    )
    return MvecFile(enc=enc, ids=np.array(ids, dtype=np.uint64), index_type=int(index_type),
                    index_param=int(index_param), index_data=blob,
                    index_param2=int(param2))
