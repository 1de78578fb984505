"""Encode pipeline: prepare -> RHDH -> Lloyd-Max -> nibble pack (+ norms).

Counterpart of ``repro/core/quantize.py`` for bits=4.  Packed layout: two
codes per byte, code[2i] in the low nibble and code[2i+1] in the high nibble
(d=1024 -> 512 bytes per vector).  2-bit and mixed 4/2-bit encodes are
ROADMAP A3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import lloydmax
from .rhdh import rhdh_apply
from .standardize import COSINE, GlobalStd, prepare


def _require_4bit(bits: int) -> None:
    if bits != 4:
        raise NotImplementedError(
            f"bits={bits} is not ported yet (ROADMAP A3: 2-bit and mixed "
            f"precision); the port encodes bits=4 only")


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


@dataclasses.dataclass
class Encoded:
    """A quantized corpus (the in-memory form of the .mvec payload)."""

    packed: torch.Tensor         # [n, d'/2] uint8
    qnorms: torch.Tensor         # [n] f32: norm of the DEQUANTIZED rotated vector
    seed: int                    # RHDH seed (lives in the .mvec header)
    metric: str
    bits: int
    dim: int                     # original input dim d
    dim_pad: int                 # rotated dim d' = next_pow2(d)
    n4_dims: int = 0
    std: Optional[GlobalStd] = None
    coarse: Optional[str] = None           # binarized coarse-code kind ("sign"/"crumb")
    ccodes: Optional[torch.Tensor] = None  # [n, code_bytes] uint8 coarse codes (v10)

    @property
    def n(self) -> int:
        return int(self.packed.shape[0])

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def bytes_per_vector(self) -> int:
        return int(self.packed.shape[-1])


def encode(
    x: torch.Tensor,
    *,
    metric: str = COSINE,
    seed: int = 0x6D6F6E61,  # "mona"
    bits: int = 4,
    std: Optional[GlobalStd] = None,
) -> Encoded:
    """Full pipeline on a [n, d] batch, on x's device."""
    _require_4bit(bits)
    d = x.shape[1]
    prepared = prepare(x.to(torch.float32), metric, std)
    rot = rhdh_apply(prepared, seed, normalized=False)   # quantizer space: ~N(0,1)
    codes = lloydmax.quantize(rot, bits)
    deq = lloydmax.dequantize(codes, bits)
    qnorms = torch.linalg.vector_norm(deq, dim=-1)
    return Encoded(packed=pack_4bit(codes), qnorms=qnorms, seed=seed, metric=metric,
                   bits=bits, dim=d, dim_pad=rot.shape[-1], std=std)


def decode(enc: Encoded) -> torch.Tensor:
    """Dequantize to rotated-space f32 (debug / oracle path)."""
    _require_4bit(enc.bits)
    return lloydmax.dequantize(unpack_4bit(enc.packed), 4)


def encode_query(q: torch.Tensor, enc_meta: Encoded) -> torch.Tensor:
    """Query-side preparation: the corpus's prepare + rotate, no quantization
    (asymmetric scoring keeps the query in f32, paper §3.3)."""
    prepared = prepare(q.to(torch.float32), enc_meta.metric, enc_meta.std)
    return rhdh_apply(prepared, enc_meta.seed, normalized=False)
