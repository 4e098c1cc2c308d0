"""A frozen copy of the sampler's counter-hash noise.

The sampler draws each point's label and sub-label with Gumbel noise from
a counter hash of (seed, hash tile, row in tile, column): murmur3's
finalizer over uint32 values.  The formula is copied here, not imported,
so that a change to the port's noise shows as a wrong answer.  uint32
arithmetic is emulated in int64.  The uniform is formed in float32 as the
port forms it; the logs are taken in float64.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SUB_SALT = 0xA5A5A5A5
# the largest noise the formula can give: u's largest float32 value
G_MAX = -math.log(-math.log(float(torch.tensor(
    (2 ** 24 - 1) * 2.0 ** -24, dtype=torch.float32) + torch.tensor(
        1e-12, dtype=torch.float32))))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def tile_seeds(seed: int, rows: torch.Tensor, tile: int,
               tile_off: int = 0) -> torch.Tensor:
    """Each row's hash seed: fmix32(seed + (tile_off + row // tile) *
    golden), int64-held uint32."""
    t = (tile_off + rows // tile) & MASK32
    return _fmix32((_mul32(t, GOLDEN) + (int(seed) & MASK32)) & MASK32)


def noise(s: torch.Tensor, rows_in_tile: torch.Tensor, col: torch.Tensor,
          width: int) -> torch.Tensor:
    """float64 Gumbel noise of rows with hash seeds ``s`` at columns ``col``
    of a ``width``-wide draw (all three broadcast): counter ``row_in_tile *
    width + col``, bits fmix32(fmix32(ctr + s) ^ (s * golden)), u = (bits
    >> 8) 2^-24 + 1e-12 in float32, G = -log(-log u)."""
    ctr = rows_in_tile * width + col
    bits = _fmix32(_fmix32((ctr + s) & MASK32) ^ _mul32(s, GOLDEN))
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u.to(torch.float64)))
