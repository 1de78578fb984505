"""Encode pipeline: prepare -> RHDH -> Lloyd-Max -> pack (+ norms).

Counterpart of ``repro/core/quantize.py``.  Packed layouts:

* 4-bit: two codes per byte, code[2i] in the low nibble and code[2i+1] in
  the high nibble (d'=1024 -> 512 bytes per vector);
* 2-bit: four codes per byte, code[4i+s] in bits 2s..2s+1;
* mixed (bits=3): ``[4-bit block | 2-bit block]`` per vector, the 4-bit
  block holding the first ``n4_dims`` rotated dims: the leading dims, or
  the top-variance dims under a persisted permutation (format v7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import lloydmax
from .rhdh import rhdh_apply
from .standardize import COSINE, GlobalStd, prepare

#: The bit widths an Encoded can have: 2, 3 (mixed 4/2) and 4.
BIT_WIDTHS = (2, 3, 4)


def bytes_per_vector(dim_pad: int, bits: int, n4_dims: int = 0) -> int:
    """Packed bytes of one row for a rotated dim d'."""
    if bits == 4:
        return dim_pad // 2
    if bits == 2:
        return dim_pad // 4
    if bits == 3:
        return n4_dims // 2 + (dim_pad - n4_dims) // 4
    raise ValueError(f"unsupported bits={bits}: expected one of {BIT_WIDTHS}")


def pack_4bit(codes: torch.Tensor) -> torch.Tensor:
    """[..., d] uint8 codes in [0,16) -> [..., d//2] packed bytes."""
    d = codes.shape[-1]
    if d % 2:
        raise ValueError(f"4-bit packing requires an even dim, got {d}")
    c = codes.reshape(codes.shape[:-1] + (d // 2, 2)).to(torch.uint8)
    return c[..., 0] | (c[..., 1] << 4)


def unpack_4bit(packed: torch.Tensor) -> torch.Tensor:
    """[..., d//2] packed bytes -> [..., d] uint8 codes."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))


def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """[..., d] uint8 codes in [0,4) -> [..., d//4] packed bytes."""
    d = codes.shape[-1]
    if d % 4:
        raise ValueError(f"2-bit packing requires dim % 4 == 0, got {d}")
    c = codes.reshape(codes.shape[:-1] + (d // 4, 4)).to(torch.uint8)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    """[..., d//4] packed bytes -> [..., d] uint8 codes."""
    parts = [(packed >> (2 * s)) & 0x3 for s in range(4)]
    return torch.stack(parts, dim=-1).reshape(packed.shape[:-1] + (packed.shape[-1] * 4,))


@dataclasses.dataclass
class Encoded:
    """A quantized corpus (the in-memory form of the .mvec payload)."""

    packed: torch.Tensor         # [n, bytes_per_vector] uint8
    qnorms: torch.Tensor         # [n] f32: norm of the DEQUANTIZED rotated vector
    seed: int                    # RHDH seed (lives in the .mvec header)
    metric: str
    bits: int                    # 4, 2 or 3 (mixed)
    dim: int                     # original input dim d
    dim_pad: int                 # rotated dim d' = next_pow2(d)
    n4_dims: int = 0             # 4-bit dims in mixed mode (header N4_DIMS)
    std: Optional[GlobalStd] = None
    perm: Optional[np.ndarray] = None      # [d'] int32 variance permutation (v7)
    coarse: Optional[str] = None           # binarized coarse-code kind ("sign"/"crumb")
    ccodes: Optional[torch.Tensor] = None  # [n, code_bytes] uint8 coarse codes (v10)
    # The permutation as an index on the codes' device, copied once: a fresh
    # host-to-device copy on each query would wait for the stream.
    perm_index: Optional[torch.Tensor] = dataclasses.field(
        init=False, repr=False, compare=False, default=None)

    def __post_init__(self):
        if self.perm is not None:
            self.perm = np.asarray(self.perm, dtype=np.int32)
            self.perm_index = torch.as_tensor(self.perm, dtype=torch.long).to(
                self.packed.device)

    @property
    def n(self) -> int:
        return int(self.packed.shape[0])

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def bytes_per_vector(self) -> int:
        return int(self.packed.shape[-1])


def _quantize_rotated(rot: torch.Tensor, bits: int, table: str = "lloydmax"):
    """Rotated f32 -> (codes, dequantized values)."""
    codes = lloydmax.quantize(rot, bits, table=table)
    return codes, lloydmax.dequantize(codes, bits, table=table)


def encode(
    x: torch.Tensor,
    *,
    metric: str = COSINE,
    seed: int = 0x6D6F6E61,  # "mona"
    bits: int = 4,
    std: Optional[GlobalStd] = None,
    table: str = "lloydmax",
) -> Encoded:
    """Full pipeline on a [n, d] batch, on x's device; bits 2 or 4.
    ``table="uniform"`` quantizes with the uniform ablation's tables (the
    paper's Table 7); ``decode`` and the scans read Lloyd-Max centroids, as
    the reference's do."""
    if bits not in (2, 4):
        raise ValueError(f"encode takes bits 2 or 4, got {bits}; use encode_mixed for the "
                         f"4/2 split")
    prepared = prepare(x.to(torch.float32), metric, std)
    rot = rhdh_apply(prepared, seed, normalized=False)   # quantizer space: ~N(0,1)
    return encode_rotated(rot, dim=x.shape[1], metric=metric, seed=seed, bits=bits, std=std,
                          table=table)


def encode_rotated(rot: torch.Tensor, *, dim: int, metric: str, seed: int, bits: int,
                   std: Optional[GlobalStd], table: str = "lloydmax") -> Encoded:
    """``encode``'s quantize, norms and pack of rows it has already rotated
    (``rhdh_apply(prepare(x), seed, normalized=False)``); bits 2 or 4."""
    if bits not in (2, 4):
        raise ValueError(f"encode takes bits 2 or 4, got {bits}; use encode_mixed for the "
                         f"4/2 split")
    codes, deq = _quantize_rotated(rot, bits, table)
    qnorms = torch.linalg.vector_norm(deq, dim=-1)
    packed = pack_4bit(codes) if bits == 4 else pack_2bit(codes)
    return Encoded(packed=packed, qnorms=qnorms, seed=seed, metric=metric,
                   bits=bits, dim=int(dim), dim_pad=rot.shape[-1], std=std)


def decode(enc: Encoded) -> torch.Tensor:
    """Dequantize to rotated-space f32 (debug / oracle path)."""
    if enc.bits == 4:
        return lloydmax.dequantize(unpack_4bit(enc.packed), 4)
    if enc.bits == 2:
        return lloydmax.dequantize(unpack_2bit(enc.packed), 2)
    if enc.bits == 3:
        return decode_mixed(enc)
    raise ValueError(f"unsupported bits={enc.bits}: expected one of {BIT_WIDTHS}")


# ---------------------------------------------------------------------------
# Mixed precision (paper §3.2): the 4-bit / 2-bit split.
# ---------------------------------------------------------------------------

def allocate_bits(dim_pad: int, avg_bits: float) -> int:
    """Number of 4-bit dims n4 with (4 n4 + 2 (d'-n4)) / d' == avg_bits,
    clamped to [0, d'] and rounded down to a multiple of 4 so both blocks pack."""
    n4 = int(round(dim_pad * (avg_bits - 2.0) / 2.0))
    n4 = max(0, min(dim_pad, n4))
    return (n4 // 4) * 4


def variance_permutation(sample_rot: torch.Tensor) -> np.ndarray:
    """Dims sorted by descending (population) variance over a rotated sample,
    ties to the lower index: [d'] int32 on the host."""
    var = torch.var(sample_rot.to(torch.float32), dim=0, correction=0)
    return np.argsort(-var.cpu().numpy(), kind="stable").astype(np.int32)


def encode_mixed(
    x: torch.Tensor,
    *,
    metric: str = COSINE,
    seed: int = 0x6D6F6E61,
    avg_bits: float = 3.0,
    std: Optional[GlobalStd] = None,
    perm: Optional[np.ndarray] = None,
    n4_dims: Optional[int] = None,
) -> Encoded:
    """Mixed 4/2-bit encoding.  With ``perm`` None the 4-bit block holds the
    leading rotated dims; a variance permutation puts the top-variance dims
    there and is persisted (v7).  ``n4_dims`` pins the split instead of
    deriving it from ``avg_bits``."""
    d = x.shape[1]
    prepared = prepare(x.to(torch.float32), metric, std)
    rot = rhdh_apply(prepared, seed, normalized=False)
    d_pad = rot.shape[-1]
    n4 = allocate_bits(d_pad, avg_bits) if n4_dims is None else int(n4_dims)
    if not 0 <= n4 <= d_pad or n4 % 4:
        raise ValueError(f"n4_dims={n4} must be a multiple of 4 in [0, {d_pad}]")
    if perm is not None:
        perm = np.asarray(perm, dtype=np.int32)
        if perm.shape != (d_pad,):
            raise ValueError(f"perm must have shape ({d_pad},), got {perm.shape}")
        rot = rot[:, torch.as_tensor(perm, dtype=torch.long).to(rot.device)]
    codes4, deq4 = _quantize_rotated(rot[:, :n4], 4)
    codes2, deq2 = _quantize_rotated(rot[:, n4:], 2)
    qnorms = torch.sqrt(torch.sum(deq4 * deq4, dim=-1) + torch.sum(deq2 * deq2, dim=-1))
    packed = torch.cat([pack_4bit(codes4), pack_2bit(codes2)], dim=-1)
    return Encoded(packed=packed, qnorms=qnorms, seed=seed, metric=metric, bits=3,
                   dim=d, dim_pad=d_pad, n4_dims=n4, std=std, perm=perm)


def decode_mixed(enc: Encoded) -> torch.Tensor:
    """Dequantize a mixed corpus to rotated-space f32, in the original dim
    order when it carries a permutation."""
    b4 = enc.n4_dims // 2
    deq = torch.cat([lloydmax.dequantize(unpack_4bit(enc.packed[:, :b4]), 4),
                     lloydmax.dequantize(unpack_2bit(enc.packed[:, b4:]), 2)], dim=-1)
    if enc.perm is not None:
        inv = torch.empty_like(enc.perm_index)
        inv[enc.perm_index] = torch.arange(enc.dim_pad, device=inv.device)
        deq = deq[:, inv]
    return deq


def encode_query(q: torch.Tensor, enc_meta: Encoded) -> torch.Tensor:
    """Query-side preparation: the corpus's prepare + rotate (+ its
    permutation), no quantization (asymmetric scoring keeps the query in
    f32, paper §3.3)."""
    prepared = prepare(q.to(torch.float32), enc_meta.metric, enc_meta.std)
    rot = rhdh_apply(prepared, enc_meta.seed, normalized=False)
    if enc_meta.perm_index is not None:
        rot = rot[..., enc_meta.perm_index]
    return rot
