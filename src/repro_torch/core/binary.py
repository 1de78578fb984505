"""Binarized coarse codes and the cascade's three stages (counterpart of
``repro/core/binary.py``; DESIGN.md §11).

The coarse code is a pure function of the packed codes.  The Lloyd-Max
boundary tables put 0.0 at their middle, so a 4-bit code is >= 8 (a 2-bit
code >= 2) exactly where the rotated coordinate is >= 0.  Per dim, the
**crumb** is the top two bits of the code: ``code >> 2`` for a 4-bit code,
the code itself for a 2-bit one, and for a mixed row the crumbs of its
4-bit dims then those of its 2-bit dims:

* the **sign** code is the crumb's hi bit, 8 dims per byte in the
  ``np.packbits(bitorder="little")`` layout: d'/8 bytes per row;
* the **crumb** code is stored as two such bit planes, the hi plane then
  the lo plane: d'/4 bytes per row.

For a 4-bit corpus byte i of a packed row holds code 2i in bits 0-3 and code
2i+1 in bits 4-7, so the sign (and crumb hi) bit of dim 2i is bit 3 of byte
i and that of dim 2i+1 is bit 7; the crumb lo bits are bits 2 and 6, and
``derive_codes`` packs those bits straight from the packed bytes.  For 2-bit
and mixed corpora it unpacks the per-dim crumbs first and packs their bit
planes after: a mixed split that is not a multiple of 8 dims puts dims of
both blocks into one coarse byte.  Either way it runs on the codes' device.

Query side, the sign bit is ``q_rot >= 0`` (the corpus predicate) and the
crumb planes come from the 2-bit Lloyd-Max code of the rotated query, both
derived inside the coarse stage from the rotated query that the rescore
uses.  The proxies are integers (``-hamming`` for sign, the symmetric-level
affinity for crumb), so kernel and plain version agree exactly, and the
survivor stage breaks ties by row order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..kernels import ops
from . import lloydmax
from . import quantize as qz

#: The stage factories the determinism audit must witness (analysis/grid.py).
PLAN_STAGES = ("coarse_scan_stage", "survivor_topk_stage", "gathered_rescore_stage")

SIGN = "sign"
CRUMB = "crumb"
COARSE_KINDS = (SIGN, CRUMB)

#: The reference's default rescore budget multiplier (m = mult * k
#: candidates; m >= n collapses to the full scan).  ``search`` does not
#: apply it: a cascade runs only when the caller passes ``rescore_mult``.
DEFAULT_RESCORE_MULT = 32

#: Bound on |proxy| for any d' the port takes: proxies lie in [-9 d', 9 d'],
#: so int32 sums never overflow and every live proxy sits far above ``INT_NEG``.
VBOUND_MAX = 1 << 29

#: The proxy that dead rows carry inside survivor selection.
INT_NEG = -(1 << 31)

_BIT_WEIGHTS = tuple(1 << t for t in range(8))   # little-endian bit weights


def code_bytes(dim_pad: int, kind: str) -> int:
    """Packed coarse-code bytes per vector for a rotated dim d'."""
    if kind not in COARSE_KINDS:
        raise ValueError(f"unknown coarse kind {kind!r}; expected one of {COARSE_KINDS}")
    if dim_pad % 8 != 0:
        raise ValueError(f"{kind} code requires dim_pad % 8 == 0, got {dim_pad}")
    return dim_pad // 8 if kind == SIGN else dim_pad // 4


def _pack_code_bits(packed: torch.Tensor, shift_even: int, shift_odd: int) -> torch.Tensor:
    """[n, d'/2] packed codes -> [n, d'/8] bytes of one bit per dim: bit
    ``shift_even`` of byte i for dim 2i, bit ``shift_odd`` for dim 2i+1."""
    quads = packed.reshape(packed.shape[0], -1, 4)   # 4 bytes = 8 dims = 1 out byte
    out = torch.zeros(quads.shape[:2], dtype=torch.uint8, device=packed.device)
    for j in range(4):
        byte = quads[..., j]
        out |= ((byte >> shift_even) & 1) << (2 * j)
        out |= ((byte >> shift_odd) & 1) << (2 * j + 1)
    return out


def _crumbs(packed: torch.Tensor, bits: int, n4_dims: int) -> torch.Tensor:
    """Per-dim crumbs [n, d'] in [0, 4) of a 2-bit or mixed corpus."""
    if bits == 2:
        return qz.unpack_2bit(packed)
    if bits == 3:
        b4 = n4_dims // 2
        return torch.cat([qz.unpack_4bit(packed[:, :b4]) >> 2,
                          qz.unpack_2bit(packed[:, b4:])], dim=1)
    raise ValueError(f"unsupported bits={bits}: expected one of {qz.BIT_WIDTHS}")


def derive_codes(packed: torch.Tensor, *, bits: int, dim_pad: int, kind: str,
                 n4_dims: int = 0) -> torch.Tensor:
    """The packed coarse code [n, code_bytes(dim_pad, kind)] uint8 of a
    corpus of any bit mode, on the codes' device."""
    nbytes = code_bytes(dim_pad, kind)                # validates kind and d'
    if bits == 4:
        sign = _pack_code_bits(packed, 3, 7)          # code >= 8: the crumb's hi bit
        lo = None if kind == SIGN else _pack_code_bits(packed, 2, 6)
    else:
        crumbs = _crumbs(packed, bits, n4_dims)
        sign = _pack_bits(crumbs >> 1)
        lo = None if kind == SIGN else _pack_bits(crumbs & 1)
    out = sign if kind == SIGN else torch.cat([sign, lo], dim=1)
    assert out.shape == (packed.shape[0], nbytes)
    return out


def attach_coarse(enc: qz.Encoded, kind: str) -> qz.Encoded:
    """A copy of ``enc`` carrying the derived coarse code (idempotent)."""
    ccodes = derive_codes(enc.packed, bits=enc.bits, dim_pad=enc.dim_pad, kind=kind,
                          n4_dims=enc.n4_dims)
    return dataclasses.replace(enc, coarse=kind, ccodes=ccodes)


# ---------------------------------------------------------------------------
# Query-side coarse encodings (inside the coarse stage).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _bit_weights(device: torch.device) -> torch.Tensor:
    # Cached: a fresh host-to-device copy each search would wait for the stream.
    return torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=device)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[b, d] of 0/1 -> [b, d/8] uint8, little-endian within each byte."""
    b, d = bits.shape
    return torch.sum(bits.to(torch.uint8).reshape(b, d // 8, 8) * _bit_weights(bits.device),
                     dim=-1).to(torch.uint8)


def query_sign_bits(q_rot: torch.Tensor) -> torch.Tensor:
    """[b, d'] rotated f32 -> [b, d'/8] packed sign bytes (little-endian)."""
    return _pack_bits(q_rot >= 0)


def query_crumb_planes(q_rot: torch.Tensor) -> torch.Tensor:
    """[b, d'] rotated f32 -> [b, d'/4] packed crumb planes (hi || lo bytes):
    the 2-bit Lloyd-Max code of the query in the corpus's plane layout."""
    c2 = lloydmax.quantize(q_rot, 2)
    return torch.cat([_pack_bits(c2 >> 1), _pack_bits(c2 & 1)], dim=-1)


# ---------------------------------------------------------------------------
# Cascade stages (engine/plan.py runs them in order).
# ---------------------------------------------------------------------------

def coarse_scan_stage(q_rot: torch.Tensor, ccodes: torch.Tensor, *, kind: str) -> torch.Tensor:
    """Integer proxy scores [b, n] (int32), higher = closer for both kinds."""
    if kind == SIGN:
        return -ops.sign_coarse_raw(ccodes, query_sign_bits(q_rot))
    if kind == CRUMB:
        return ops.crumb_coarse_raw(ccodes, query_crumb_planes(q_rot))
    raise ValueError(f"unknown coarse kind {kind!r}")


def survivor_topk_stage(proxy: torch.Tensor, live: Optional[torch.Tensor], *,
                        m: int) -> torch.Tensor:
    """Top-m survivor rows [b, m] (int32), ascending, -1 after the real ones.

    The stable top-m of the live proxies (ties to the lowest row), as one
    ``torch.topk`` over the unique int64 key ``proxy * 2^32 + (2^32-1-row)``:
    a higher proxy wins, and among equal proxies the lower row.  Dead rows
    (``live`` False; None means every row is live) carry ``INT_NEG``, below
    every live proxy, so they surface only when fewer than m rows are live,
    and then come back as -1.
    """
    n = proxy.shape[1]
    tiebreak = torch.arange((1 << 32) - 1, (1 << 32) - 1 - n, -1, dtype=torch.int64,
                            device=proxy.device)
    masked = proxy if live is None else torch.where(live[None, :], proxy, INT_NEG)
    key = torch.add(tiebreak, masked, alpha=1 << 32)
    top = torch.topk(key, min(m, n), dim=-1, sorted=False).indices
    if live is not None:
        top = torch.where(live[top], top, n)          # dead -> after every real row
    top = torch.sort(top, dim=-1).values
    cand = torch.where(top < n, top, -1).to(torch.int32)
    if m > n:
        cand = torch.nn.functional.pad(cand, (0, m - n), value=-1)
    return cand


def gathered_rescore_stage(q_rot: torch.Tensor, packed: torch.Tensor, qnorms: torch.Tensor,
                           cand: torch.Tensor, *, bits: int, metric: str,
                           n4_dims: int = 0) -> torch.Tensor:
    """Metric-adjusted rescores [b, m] at the corpus's own precision; dead
    survivors come back NEG."""
    return ops.score_gathered(packed, q_rot, cand, bits=bits, n4_dims=n4_dims,
                              qnorms=qnorms, metric=metric)

