"""`.mvec` single-file index format, versions 6, 7, 8 and 10 (subset of
``repro/core/mvec_format.py``; paper §3.8, DESIGN.md §2, §6 and §11).

A fixed 56-byte little-endian header, then length-prefixed blocks:

    0   MAGIC       4s   b"MVEC"
    4   VERSION     u32  6, 7 (a permutation block), 8 (segments and
                         tombstones) or 10 (coarse codes)
    8   DIM         u32  input dimension d
    12  METRIC      u8   0=Cosine 1=Dot 2=L2
    13  BIT_WIDTH   u8   2, 3 (mixed 4/2) or 4
    14  INDEX_TYPE  u8   0=BruteForce 1=IvfFlat 2=HNSW
    15  PAD         u8
    16  COUNT       u64  rows of the BASE segment (extras carry their own)
    24  SEED        u64  root rotation seed
    32  N4_DIMS     u32  4-bit dims of a mixed row
    36  INDEX_PARAMS 8B  (u32, u32)
    44  HAS_STD     u8   1 if the global standardization block follows
    45  HAS_PERM    u8   v8 and later: 1 if the PERM block follows (v7 says
                         so through VERSION; always 0 in v6 and v7)
    46  COARSE_KIND u8   v10: 1=sign 2=crumb (0 before version 10)
    47  HAS_META    u8   v10: 1 if metadata columns follow (ROADMAP A6)
    48  (8 bytes)        zero

Blocks: STD_MEAN [f32 x dim] and STD_INV_STD [f32 x dim] (if HAS_STD), PERM
[i32 x d'] (v7, or v8/v10 with HAS_PERM), then VECTORS [u8], IDS [u64], NORMS
[f32] (each with a u64 byte length), then INDEX_DATA (u64 length + bytes).
A row of VECTORS is d'/2 bytes (4-bit), d'/4 (2-bit), or N4_DIMS/2 +
(d'-N4_DIMS)/4 (mixed).  Version 8 appends the segment table:

    SEG_COUNT  u32               number of EXTRA segments (>= 0)
    per extra segment, in ordinal order:
        SEG_SEED u64, SEG_VECTORS [u8], SEG_IDS [u64], SEG_NORMS [f32]
    per segment INCLUDING the base, in order:
        TOMBS      [u8]          np.packbits deletion bitmap (bit set = dead)

Version 10 writes the v8 body (SEG_COUNT may be 0 and every bitmap clear),
then one CODE block [u8, n x code_bytes] per segment, base first.  ``save``
picks the version as the reference does: 10 with coarse codes, else 8 when
the index has extra segments or a tombstone, else 7 with a permutation, else
6; so a static or compacted index still writes v6/v7.  Every read is checked
against the bytes present, so a truncated or garbage-tailed file raises
ValueError naming the block.  A file the port cannot represent raises
NotImplementedError naming the ROADMAP item: version 9 and a v10 file with
metadata columns (A6), version 11 (A11).  IVF and HNSW files load here as
plain data (``index_data``; ``unpack_ivf_blob``), their search is A7 and A8.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List, Optional

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
VERSION_SEGMENTS = 8
VERSION_COARSE = 10
_COARSE_CODE = {"sign": 1, "crumb": 2}
_COARSE_NAME = {v: k for k, v in _COARSE_CODE.items()}
_UNPORTED_VERSION = {9: "A6: metadata columns", 11: "A11: autotune results"}
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
class ExtraSegment:
    """One segment that add() appended, as the v8 segment table holds it."""

    enc: qz.Encoded
    ids: np.ndarray


@dataclasses.dataclass
class MvecFile:
    enc: qz.Encoded
    ids: np.ndarray
    index_type: int
    index_param: int = 0
    index_data: Optional[bytes] = None
    index_param2: int = 0
    extras: List[ExtraSegment] = dataclasses.field(default_factory=list)
    tombs: Optional[List[np.ndarray]] = None   # [1 + len(extras)] bool bitmaps


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype)


def save(path: str, f: MvecFile) -> None:
    """Write version 10 when the segments carry coarse codes, else 8 when
    there is an extra segment or a tombstone, else 7 with a permutation,
    else 6."""
    enc = f.enc
    seg_encs = [enc] + [e.enc for e in f.extras]
    with_codes = [e.ccodes is not None for e in seg_encs]
    has_codes = any(with_codes)
    if has_codes and not all(with_codes):
        raise ValueError("coarse codes must be attached to every segment or to none "
                         f"({sum(with_codes)} of {len(with_codes)} segments have them)")
    if has_codes and any(e.coarse != enc.coarse for e in seg_encs):
        raise ValueError("segments disagree on the coarse-code kind")
    mutated = bool(f.extras) or (f.tombs is not None and any(t.any() for t in f.tombs))
    if has_codes:
        version = VERSION_COARSE
    elif mutated:
        version = VERSION_SEGMENTS
    else:
        version = VERSION_PERM if enc.perm is not None else VERSION
    has_std = enc.std is not None
    has_perm = enc.perm is not None
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
    _write_array(buf, _host(enc.packed, np.uint8))
    _write_array(buf, np.asarray(f.ids, dtype=np.uint64))
    _write_array(buf, _host(enc.qnorms, np.float32))
    blob = f.index_data or b""
    buf.write(struct.pack("<Q", len(blob)))
    buf.write(blob)
    if version >= VERSION_SEGMENTS:
        buf.write(struct.pack("<I", len(f.extras)))
        for e in f.extras:
            buf.write(struct.pack("<Q", e.enc.seed & 0xFFFFFFFFFFFFFFFF))
            _write_array(buf, _host(e.enc.packed, np.uint8))
            _write_array(buf, np.asarray(e.ids, dtype=np.uint64))
            _write_array(buf, _host(e.enc.qnorms, np.float32))
        tombs = f.tombs or [np.zeros(e.n, dtype=bool) for e in seg_encs]
        for t in tombs:
            _write_array(buf, np.packbits(np.asarray(t, dtype=bool)))
    if has_codes:
        for e in seg_encs:
            _write_array(buf, _host(e.ccodes, np.uint8))
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


def load(path: str, device: torch.device | str = "cpu") -> MvecFile:
    """Parse a version 6, 7, 8 or 10 file; codes, norms and coarse codes of
    every segment land on ``device``, ids and tombstones stay on the host."""
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
            f"; the port reads versions 6, 7, 8 and 10")
    if version not in (VERSION, VERSION_PERM, VERSION_SEGMENTS, VERSION_COARSE):
        raise ValueError(
            f"unsupported .mvec version {version}: the port reads versions 6, 7, 8 and 10")
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
        perm = rd.array(np.int32, "perm", count=dim_pad).copy()
        if not np.array_equal(np.sort(perm), np.arange(dim_pad)):
            raise ValueError(f".mvec corrupt block 'perm': not a permutation of "
                             f"range({dim_pad})")
    bytes_per = qz.bytes_per_vector(dim_pad, bits, n4_dims)

    def read_segment(prefix: str, n_rows: Optional[int], seg_seed: int):
        packed = rd.array(np.uint8, f"{prefix}vectors")
        if n_rows is None:
            if packed.size % bytes_per:
                raise ValueError(f".mvec corrupt block '{prefix}vectors': {packed.size} bytes "
                                 f"is not a multiple of {bytes_per} bytes a row")
            n_rows = packed.size // bytes_per
        elif packed.size != n_rows * bytes_per:
            raise ValueError(f".mvec corrupt block '{prefix}vectors': expected "
                             f"{n_rows * bytes_per} bytes ({n_rows} rows x {bytes_per}), "
                             f"found {packed.size}")
        ids = rd.array(np.uint64, f"{prefix}ids", count=n_rows)
        qnorms = rd.array(np.float32, f"{prefix}norms", count=n_rows)
        seg_enc = qz.Encoded(
            packed=torch.from_numpy(packed.reshape(n_rows, bytes_per).copy()).to(device),
            qnorms=torch.from_numpy(qnorms.astype(np.float32)).to(device),
            seed=int(seg_seed), metric=_METRIC_NAME[metric_c], bits=int(bits), dim=int(dim),
            dim_pad=dim_pad, n4_dims=int(n4_dims), std=std, perm=perm)
        return seg_enc, np.array(ids, dtype=np.uint64)

    enc, ids = read_segment("", int(count), int(seed))
    blob_len = rd.u64("index_data length")
    blob = rd.take(blob_len, "index_data") if blob_len else None
    extras: List[ExtraSegment] = []
    tombs: Optional[List[np.ndarray]] = None
    if version >= VERSION_SEGMENTS:
        for i in range(rd.u32("segment table")):
            seg_seed = rd.u64(f"segment[{i}] seed")
            extras.append(ExtraSegment(*read_segment(f"segment[{i}] ", None, seg_seed)))
        tombs = []
        for i, n_rows in enumerate([int(count)] + [e.ids.shape[0] for e in extras]):
            packed_bits = rd.array(np.uint8, f"tombstones[{i}]", count=(n_rows + 7) // 8)
            tombs.append(np.unpackbits(packed_bits)[:n_rows].astype(bool))
    if version == VERSION_COARSE and tail[1]:
        raise NotImplementedError(".mvec metadata columns are not ported yet "
                                  "(ROADMAP A6: metadata columns)")
    if coarse is not None:
        cb = code_bytes(dim_pad, coarse)
        seg_codes = []
        for i, e in enumerate([enc] + [x.enc for x in extras]):
            codes = rd.array(np.uint8, f"coarse codes[{i}]", count=e.n * cb)
            seg_codes.append(torch.from_numpy(codes.reshape(e.n, cb).copy()).to(device))
        enc = dataclasses.replace(enc, coarse=coarse, ccodes=seg_codes[0])
        for x, cc in zip(extras, seg_codes[1:]):
            x.enc = dataclasses.replace(x.enc, coarse=coarse, ccodes=cc)
    rd.expect_eof()
    return MvecFile(enc=enc, ids=ids, index_type=int(index_type),
                    index_param=int(index_param), index_data=blob,
                    index_param2=int(param2), extras=extras, tombs=tombs)


# ---------------------------------------------------------------------------
# Backend blobs (INDEX_DATA): length-prefixed numpy arrays.
# ---------------------------------------------------------------------------

def pack_ivf_blob(centroids: np.ndarray, order: np.ndarray, offsets: np.ndarray) -> bytes:
    """An IVF index's INDEX_DATA: centroids [nlist, d] f32, (nlist, d) u32,
    the CSR row order and offsets (i64)."""
    buf = io.BytesIO()
    _write_array(buf, centroids.astype(np.float32))
    buf.write(struct.pack("<II", *centroids.shape))
    _write_array(buf, order.astype(np.int64))
    _write_array(buf, offsets.astype(np.int64))
    return buf.getvalue()


def unpack_ivf_blob(blob: bytes):
    """(centroids [nlist, d] f32, order i64, offsets i64) of an IVF INDEX_DATA."""
    rd = _Reader(blob, 0)
    cents = rd.array(np.float32, "ivf centroids")
    nlist = rd.u32("ivf nlist")
    d = rd.u32("ivf dim")
    if cents.size != nlist * d:
        raise ValueError(f".mvec corrupt block 'ivf centroids': expected {nlist * d} "
                         f"elements, found {cents.size}")
    order = rd.array(np.int64, "ivf order")
    offsets = rd.array(np.int64, "ivf offsets")
    rd.expect_eof()
    return cents.reshape(nlist, d), order, offsets
