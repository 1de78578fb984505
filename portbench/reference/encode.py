"""The plain encode: unit rows -> seeded Hadamard rotation -> 4-bit Lloyd-Max
codes, packed two a byte, and each row's dequantized norm.

Plain PyTorch on whatever device the tensors are on; it imports nothing of
the program.  The reference works in f64: each row over its own norm, the
signs, a zero pad to d' and the unnormalized transform, so its rotated
values lie ~N(0, 1) and within ~1e-15 of the exact ones.  A code is a
function of its row alone, but which side of a Lloyd-Max boundary a value
falls on is not fixed by f32 arithmetic where the value lies within its
rounding of the boundary.  ``judge`` therefore accepts a program's code that
differs from the reference's by one level only where the reference's value
lies within ``TOL`` of the boundary between the two, takes that code as the
reference's own there, and counts every other difference.

``precision="tf32"`` is the control: the encode with the rotation as a
product with the Hadamard matrix whose inputs are rounded to TF32 (10
mantissa bits), the precision below the configuration's f32.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from . import signs as signs_mod

#: Half-width of the band around a boundary in which either code is
#: accepted (the quantizer's N(0, 1) units): f32 rounding of a norm and a
#: 10-stage butterfly moves a value by well under 1e-6; TF32's inputs move
#: it by ~3e-4.
TOL = 2.0 ** -16
#: Rows the encode works on at a time (bounds the f32 temporaries).
BLOCK_ROWS = 1 << 16

CENTROIDS_4BIT = np.array(
    [-2.7325895709929284, -2.0690172265288570, -1.6180463860193035,
     -1.2562311973447498, -0.9423404564848586, -0.6567591185308426,
     -0.3880482994892674, -0.1283950298507978, 0.1283950298507979,
     0.3880482994892679, 0.6567591185308430, 0.9423404564848593,
     1.2562311973447489, 1.6180463860192993, 2.0690172265288647,
     2.7325895709929156], dtype=np.float32)

BOUNDARIES_4BIT = np.array(
    [-2.4008033987608925, -1.8435318062740804, -1.4371387916820266,
     -1.0992858269148043, -0.7995497875078506, -0.5224037090100551,
     -0.2582216646700326, 0.0000000000000000, 0.2582216646700329,
     0.5224037090100555, 0.7995497875078512, 1.0992858269148040,
     1.4371387916820240, 1.8435318062740820, 2.4008033987608899], dtype=np.float32)


def next_pow2(d: int) -> int:
    p = 1
    while p < d:
        p <<= 1
    return p


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -8192).view(torch.float32)


@functools.lru_cache(maxsize=8)
def _signs_on(seed: int, d_pad: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(signs_mod.signs(seed, d_pad)).to(device)


@functools.lru_cache(maxsize=4)
def _hadamard_on(d_pad: int, device: torch.device) -> torch.Tensor:
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < d_pad:
        h = np.block([[h, h], [h, -h]]).astype(np.float32)
    return torch.from_numpy(h).to(device)


def centroids(device) -> torch.Tensor:
    return torch.from_numpy(CENTROIDS_4BIT).to(device)


def unit_rows(x: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """Each row over its own L2 norm: in f64, or in f32 for the control."""
    x = x.double() if precision == "f64" else x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def rotate(x: torch.Tensor, seed: int, precision: str = "f64") -> torch.Tensor:
    """[n, d] unit rows -> [n, d'] = H (pad(x) * signs), unnormalized, in
    x's dtype by the butterfly; the control as a product of TF32 inputs."""
    n, d = x.shape
    d_pad = next_pow2(d)
    s = _signs_on(int(seed), d_pad, x.device).to(x.dtype)
    y = torch.nn.functional.pad(x * s[:d], (0, d_pad - d))
    if precision == "tf32":
        with _no_tf32():
            return to_tf32(y.float()) @ _hadamard_on(d_pad, x.device)
    if precision != "f64":
        raise ValueError(f"unknown precision {precision!r}")
    h = 1
    while h < d_pad:
        pairs = y.reshape(n, d_pad // (2 * h), 2, h)
        a, b = pairs[:, :, 0], pairs[:, :, 1]
        y = torch.stack((a + b, a - b), dim=2).reshape(n, d_pad)
        h *= 2
    return y


@contextlib.contextmanager
def _no_tf32():
    """f32 products in full f32: the control rounds its inputs itself."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def quantize(rot: torch.Tensor) -> torch.Tensor:
    """Codes in [0, 16): how many boundaries lie at or below each value."""
    codes = torch.zeros(rot.shape, dtype=torch.uint8, device=rot.device)
    for b in BOUNDARIES_4BIT.tolist():
        codes += (rot >= b).to(torch.uint8)
    return codes


def pack(codes: torch.Tensor) -> torch.Tensor:
    """Code 2i in the low nibble of byte i, code 2i+1 in the high nibble."""
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def unpack(packed: torch.Tensor) -> torch.Tensor:
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(packed.shape[0], -1)


def dequantize64(packed: torch.Tensor) -> torch.Tensor:
    """[n, d'/2] packed codes -> [n, d'] f64 centroid values."""
    return centroids(packed.device).double()[unpack(packed).long()]


def norms64(packed: torch.Tensor) -> torch.Tensor:
    """[n] f64 norms of the dequantized rows."""
    out = torch.empty(packed.shape[0], dtype=torch.float64, device=packed.device)
    for i in range(0, packed.shape[0], BLOCK_ROWS):
        out[i:i + BLOCK_ROWS] = torch.linalg.vector_norm(
            dequantize64(packed[i:i + BLOCK_ROWS]), dim=-1)
    return out


def encode_queries(q: torch.Tensor, seed: int, precision: str = "f64") -> torch.Tensor:
    """[b, d] queries -> [b, d'] rotated (asymmetric: never quantized); f64,
    or the control's f32."""
    return rotate(unit_rows(q, precision), seed, precision)


def encode(x: torch.Tensor, seed: int, precision: str = "f64") -> torch.Tensor:
    """[n, d] corpus -> [n, d'/2] uint8 packed codes, block by block."""
    n, d = x.shape
    out = torch.empty((n, next_pow2(d) // 2), dtype=torch.uint8, device=x.device)
    for i in range(0, n, BLOCK_ROWS):
        out[i:i + BLOCK_ROWS] = pack(quantize(rotate(unit_rows(x[i:i + BLOCK_ROWS],
                                                               precision), seed, precision)))
    return out


def judge(x: torch.Tensor, seed: int, packed: torch.Tensor):
    """(code bytes that differ, [n, d'/2] the reference's codes) for a
    program's ``packed`` encode of ``x``: the reference's code at every
    position, but the program's where the two are one level apart and the
    reference's f64 value lies within TOL of the boundary between them."""
    n, d = x.shape
    bounds = torch.from_numpy(BOUNDARIES_4BIT).to(x.device).double()
    out = torch.empty((n, next_pow2(d) // 2), dtype=torch.uint8, device=x.device)
    differ = 0
    for i in range(0, n, BLOCK_ROWS):
        v = rotate(unit_rows(x[i:i + BLOCK_ROWS]), seed)
        ref = quantize(v)
        got = unpack(packed[i:i + BLOCK_ROWS])
        lo = torch.minimum(ref, got).clamp(max=bounds.numel() - 1).long()
        near = (ref.int() - got.int()).abs().eq(1) & ((v - bounds[lo]).abs() < TOL)
        out[i:i + BLOCK_ROWS] = pack(torch.where(near, got, ref))
        differ += int((out[i:i + BLOCK_ROWS] != packed[i:i + BLOCK_ROWS]).sum().item())
        del v, ref, got, lo, near
    return differ, out


def sign_codes(packed: torch.Tensor) -> torch.Tensor:
    """[n, d'/8] uint8: bit t of byte j is 1 where code 8 j + t is >= 8."""
    out = torch.empty((packed.shape[0], packed.shape[1] // 4), dtype=torch.uint8,
                      device=packed.device)
    weights = torch.tensor([1 << t for t in range(8)], dtype=torch.uint8,
                           device=packed.device)
    for i in range(0, packed.shape[0], BLOCK_ROWS):
        bits = (unpack(packed[i:i + BLOCK_ROWS]) >= 8).to(torch.uint8)
        rows = bits.shape[0]
        out[i:i + rows] = (bits.reshape(rows, -1, 8) * weights).sum(
            dim=-1, dtype=torch.uint8)
    return out
