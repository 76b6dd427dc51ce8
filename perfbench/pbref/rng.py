"""Random streams: threefry-2x32 keys and the megakernel's counter hash.

Keys are (2,) uint32 words with jax.random's history (``key(seed)``,
``fold_in``); the megakernel draws every random bit from a counter hash of
(seed words, global tile, loop iteration, element id); the wavefront
samplers fold per-pixel keys with the sample and the bounce and split them
into subkeys, one draw each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, over Python ints or int64 tensors that
    hold uint32 values; returns (y0, y1)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    a = (x0 + k0) & MASK
    b = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) & MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def key(seed: int):
    """The key of ``jax.random.key(seed)``: words (0, seed)."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return (0, int(seed))


def fold_in(k, data: int):
    """``jax.random.fold_in`` on a (w0, w1) key of Python ints."""
    return threefry2x32(int(k[0]), int(k[1]), 0, int(data) & MASK)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash_bits(w0, w1, itc: int, elem):
    """The megakernel's counter hash, stream salt 0: 32 bits as int64.
    ``w0``, ``w1`` (per-lane seed words, w1 with the tile folded in) and
    ``elem`` may be int64 tensors."""
    x = (((itc * GOLDEN) & MASK) + elem) & MASK
    x = x ^ w0
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = (x + w1) & MASK
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def tile_w1(w1_frame, tiles: torch.Tensor) -> torch.Tensor:
    """Seed word 1 of a tile: w1 + tile * GOLDEN (mod 2**32)."""
    return (w1_frame + _mul32(tiles & MASK, GOLDEN)) & MASK


# -- the wavefront samplers' draws ---------------------------------------------

_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SCALE = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def uniform(bits: torch.Tensor, dtype) -> torch.Tensor:
    """[0, 1) from 32 bits as jax.random.uniform: the top 23 bits as the
    mantissa of a float32 in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(dtype)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """Giles' float32 erfinv polynomial, XLA's operation order."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(bits: torch.Tensor, dtype) -> torch.Tensor:
    """A standard normal as jax.random.normal: sqrt(2) * erfinv of a
    uniform on (-1, 1)."""
    u = uniform(bits, dtype) * _NORMAL_SCALE + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return (_SQRT2 * _erfinv(u)).to(dtype)


def lane_draws(k0, k1, sample_i, bounce_i, with_rr: bool, dtype):
    """The draws of one wavefront bounce per lane: the pixel key folded
    with the sample and the bounce, split into 7 (8 with russian roulette)
    subkeys, one draw each: jitter x, y, z (uniform), gauss x, y, z
    (normal), Fresnel uniform [, russian-roulette uniform]."""
    k0, k1 = threefry2x32(k0, k1, 0, sample_i.to(torch.int64) & MASK)
    k0, k1 = threefry2x32(k0, k1, 0, bounce_i.to(torch.int64) & MASK)
    sub = torch.arange(8 if with_rr else 7, device=k0.device)[:, None]
    s0, s1 = threefry2x32(k0[None], k1[None], 0, sub)     # subkey i
    b0, b1 = threefry2x32(s0, s1, 0, 0)
    bits = b0 ^ b1
    return [normal(bits[i], dtype) if 3 <= i < 6 else uniform(bits[i], dtype)
            for i in range(bits.shape[0])]
