"""Random streams: threefry keys on the host and the megakernel's counter
hash.

A key is its raw data, a (2,) uint32 numpy array, bitwise equal to
``jax.random.key_data`` of the JAX key with the same history
(``key(seed)``, ``fold_in``). Frame keys give the megakernel its two seed
words; inside the kernel every random bit comes from ``hash_bits``, a
counter hash of (seed words, global tile, loop iteration, element id).
The CUDA kernel, its plain version here and the JAX megakernel in Pallas
interpret mode all evaluate that same hash, so they draw the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
GOLDEN = 0x9E3779B9      # == int32 -1640531527, the tile-seed multiplier


def _rotl(x: np.uint32, r: int) -> np.uint32:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) over uint32 scalars, as jax.random uses."""
    with np.errstate(over="ignore"):
        ks = (np.uint32(k0), np.uint32(k1),
              np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
        x = [np.uint32(x0) + ks[0], np.uint32(x1) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """Key data of ``jax.random.key(seed)`` for 0 <= seed < 2**32."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return np.array([0, int(seed)], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """Key data of ``jax.random.fold_in(k, data)`` for 0 <= data < 2**32."""
    if not 0 <= int(data) < 2 ** 32:
        raise ValueError(f"fold_in data {data} outside [0, 2**32)")
    y0, y1 = threefry2x32(k[0], k[1], 0, int(data))
    return np.array([y0, y1], np.uint32)


def key_data(k: np.ndarray) -> np.ndarray:
    """The (2,) uint32 words of a key (keys are their data here)."""
    return np.asarray(k, np.uint32).reshape(2)


def frame_key(base_key: np.ndarray, frame_num: int) -> np.ndarray:
    """Key for one progressive frame."""
    return fold_in(base_key, frame_num)


_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def hash_bits(w0: int, w1: torch.Tensor, itc: int,
              elem: torch.Tensor) -> torch.Tensor:
    """The megakernel's counter hash (raytracer_tpu megakernel.py:564-570)
    with stream salt 0, in int64 holding uint32 values.

    ``w0``: seed word 0; ``w1``: per-lane seed word 1 (frame word plus the
    global tile times GOLDEN); ``itc``: loop iteration (1, 2, ...);
    ``elem``: element id ``(row * 32 + r) * 128 + l``. Returns the 32 bits
    as int64 in [0, 2**32).
    """
    x = (((itc * GOLDEN) & _MASK) + elem) & _MASK
    x = x ^ w0
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = (x + w1) & _MASK
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_words(fkey: np.ndarray, tile_offset: int = 0):
    """(w0, w1 frame word, tile offset) for the megakernel, as the uint32
    words of the frame key (megakernel.py:1239-1241)."""
    kd = key_data(fkey)
    return int(kd[0]), int(kd[1]), int(tile_offset)


def tile_w1(w1_frame: int, tiles: torch.Tensor) -> torch.Tensor:
    """Per-tile seed word 1: w1 + tile * GOLDEN (mod 2**32); ``tiles`` are
    global tile indices (tile_offset already added), int64."""
    return (w1_frame + _mul32(tiles & _MASK, GOLDEN)) & _MASK
