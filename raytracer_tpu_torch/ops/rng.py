"""Random streams: threefry keys, the wavefront samplers' per-lane draws
and the megakernel's counter hash.

A key is its raw data, a (2,) uint32 numpy array, bitwise equal to
``jax.random.key_data`` of the JAX key with the same history
(``key(seed)``, ``fold_in``). Frame keys give the megakernel its two seed
words; inside the kernel every random bit comes from ``hash_bits``, a
counter hash of (seed words, global tile, loop iteration, element id).
The CUDA kernel, its plain version here and the JAX megakernel in Pallas
interpret mode all evaluate that same hash, so they draw the same bits.

The wavefront samplers draw as ``raytracer_tpu/ops/rng.py`` does: one key
per ray (``per_ray_keys``, a (2, N) int64 tensor holding the uint32 key
words), folded with the sample and the bounce, split into 7 subkeys (8
with russian roulette), one uniform or normal per subkey. With
``jax_threefry_partitionable`` (the default of jax 0.9) ``split(k, n)[i]``
is ``fold_in(k, i)`` and a scalar ``random.bits(k)`` is ``x0 ^ x1`` of
``threefry2x32(k, (0, 0))``; uniforms take the top 23 bits as a mantissa,
normals go through XLA's float32 erfinv polynomial (hazard H8: not
``torch.erfinv``). ``lane_randoms`` returns the per-lane draw's rows,
``lane_randoms_reference`` in int64 torch arithmetic; coherent sampling's
per-tile draw ``tile_randoms`` (``tile_rows``: the rows as one tensor) is
``tile_randoms_reference``. No kernel stands behind either: they run on
whatever device their tensors are on. The wavefront iteration draws
inside its ray set-up, ``rt_wave_rays`` (ops/rays.py), with device
functions of the same arithmetic (csrc/draw.cuh), per lane or per tile,
so no row of either draw passes through device memory on the paths.
A replayed CUDA graph (ops/wave_graph.py) cannot take a key from the
host: there the coherent draw folds the tile key held in device memory
with the iteration counter held there (``fold_in_tensor`` is that fold in
torch), and ``per_ray_keys`` takes its key as a device tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device

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


# -- the wavefront samplers' streams (raytracer_tpu/ops/rng.py:27-101) -------

# jax.random.normal draws uniform(nextafter(-1, 0), 1) and takes
# sqrt(2) * erfinv of it (jax._src.random._normal_real).
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SCALE = float(np.float32(1.0) - np.float32(_NORMAL_LO))   # 2.0
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' erfinv coefficients as XLA's float32 ErfInv uses them.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32_t(k0, k1, x0, x1):
    """``threefry2x32`` over int64 tensors (or ints) holding uint32
    values; broadcasts like elementwise ops. Returns (y0, y1)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    a = (x0 + k0) & _MASK
    b = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl32(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def sample_key(fkey: np.ndarray, sample_idx: int) -> np.ndarray:
    """Key for one of the spp samples inside a frame (rng.py:27)."""
    return fold_in(fkey, sample_idx)


def per_ray_keys(k, ray_idx: torch.Tensor) -> torch.Tensor:
    """``fold_in(k, i)`` for every global pixel index i of ``ray_idx``
    (rng.py:32-39): (2, N) int64 key words on ray_idx's device. ``k`` is
    a key (numpy) or its two words as a (2,) int64 tensor on that device
    (``set_key`` writes them), which a replayed graph reads from device
    memory; both give the same bits."""
    if isinstance(k, torch.Tensor):
        k0, k1 = k[0], k[1]
    else:
        kd = key_data(k)
        k0, k1 = int(kd[0]), int(kd[1])
    idx = ray_idx.to(torch.int64) & _MASK
    y0, y1 = threefry2x32_t(k0, k1, 0, idx)
    return torch.stack([y0, y1])


def set_key(buf: torch.Tensor, k: np.ndarray) -> None:
    """Write a key's two words into a (2,) int64 device buffer with two
    fills: no copy from host memory, so no host sync and nothing a CUDA
    graph could not replay around."""
    kd = key_data(k)
    buf[0].fill_(int(kd[0]))
    buf[1].fill_(int(kd[1]))


def fold_in_tensor(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` on tensors: ``k`` (2,) int64 key words, ``data`` an
    int64 tensor holding values in [0, 2**32); returns the (2,) int64
    words of ``fold_in(k, data)``, bitwise ``rng.fold_in``. The plain
    version of the fold ``rt_wave_rays``' coherent arm does on the card
    (csrc/draw.cuh ``tile_key``)."""
    y0, y1 = threefry2x32_t(k[0], k[1], 0, data.reshape(()) & _MASK)
    return torch.stack([y0, y1])


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits (int64), as
    jax.random.uniform: the top 23 bits become the mantissa of [1, 2)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv (Giles' polynomial), op for op."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 standard normal from 32 random bits, as jax.random.normal."""
    u = uniform_from_bits(bits) * _NORMAL_SCALE + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return _SQRT2 * erfinv_xla(u)


def lane_randoms_reference(keys: torch.Tensor, sample_i, bounce_i,
                           with_rr: bool = False) -> torch.Tensor:
    """The per-lane draw (``rt_wave_rays`` draws it in registers): per
    lane, key ``fold_in(fold_in(k, sample), bounce)`` (or
    ``fold_in(k, bounce)`` when ``sample_i`` is None), split into 7 (8
    with ``with_rr``) subkeys, one draw each. Returns (7|8, N) float32
    rows: jitter x, y, z (uniform), gauss x, y, z (normal), Fresnel
    uniform[, russian-roulette uniform]."""
    k0, k1 = keys[0], keys[1]
    if sample_i is not None:
        k0, k1 = threefry2x32_t(k0, k1, 0, sample_i.to(torch.int64) & _MASK)
    k0, k1 = threefry2x32_t(k0, k1, 0, bounce_i.to(torch.int64) & _MASK)
    rows = []
    for i in range(8 if with_rr else 7):
        s0, s1 = threefry2x32_t(k0, k1, 0, i)
        b0, b1 = threefry2x32_t(s0, s1, 0, 0)
        bits = b0 ^ b1
        rows.append(normal_from_bits(bits) if 3 <= i < 6
                    else uniform_from_bits(bits))
    return torch.stack(rows)


def _split_rows(out: torch.Tensor, with_rr: bool):
    drawn = (out[0:3], out[3:6], out[6])
    return drawn + (out[7],) if with_rr else drawn


def lane_randoms(keys: torch.Tensor, sample_i, bounce_i,
                 with_rr: bool = False):
    """Per-lane randoms of the regeneration sampler (rng.py:75-101).

    ``keys``: (2, N) int64 key words (``per_ray_keys``); ``sample_i``:
    (N,) sample index or None (no sample fold, as ``bounce_randoms``);
    ``bounce_i``: (N,) bounce index. No kernel stands behind it: it is
    ``lane_randoms_reference`` on the keys' device. Returns (jitter_u3
    (3, N), gauss (3, N), fresnel_u (N,)) and, with ``with_rr``, the
    russian-roulette uniform (N,)."""
    if keys.dim() != 2 or keys.shape[0] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (2, N) int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    n = keys.shape[1]
    for x in (sample_i, bounce_i):
        if x is not None and (x.shape != (n,) or x.device != keys.device):
            raise ValueError("sample_i / bounce_i must be (N,) on the keys' "
                             "device")
    return _split_rows(lane_randoms_reference(keys, sample_i, bounce_i,
                                              with_rr), with_rr)


def tile_randoms_reference(it_key: np.ndarray, n: int, tile: int = 1024,
                           with_rr: bool = False,
                           device="cuda") -> torch.Tensor:
    """Coherent sampling's tile draw (``rt_wave_rays``' coherent arm draws
    it in shared memory): ``split(it_key, 3|4)`` gives the subkeys; each
    draws a (3, nt) or (nt,) ``jax.random.bits`` block,
    whose element j is ``x0 ^ x1`` of ``threefry2x32(subkey, (0, j))``,
    nt = ceil(n / tile). Returns (7|8, n) float32 rows on ``device`` (the
    rows of ``lane_randoms_reference``), each tile's value repeated over
    its ``tile`` lanes and the last tile cut at ``n``. ``device`` defaults
    to the card (utils/device.py), as ``build_scene`` does."""
    device = resolve_device(device)
    nt = -(-n // tile)
    rows = []
    for s, count in enumerate((3, 3, 1, 1)[:4 if with_rr else 3]):
        k0, k1 = (int(w) for w in fold_in(it_key, s))
        j = torch.arange(count * nt, dtype=torch.int64, device=device)
        y0, y1 = threefry2x32_t(k0, k1, 0, j)
        bits = (y0 ^ y1).reshape(count, nt)
        rows.append(normal_from_bits(bits) if s == 1
                    else uniform_from_bits(bits))
    rows = torch.cat(rows)
    return rows[:, :, None].expand(-1, nt, tile).reshape(-1, nt * tile)[:, :n]


def tile_rows(it_key: np.ndarray, n: int, tile: int = 1024,
              with_rr: bool = False, device="cuda") -> torch.Tensor:
    """Coherent sampling's draw (rng.py:104-127): one bundle per ``tile``
    consecutive lanes, keyed by the caller's per-iteration key, as one
    (7|8, n) float32 tensor (the rows of ``lane_randoms_reference``), each
    row repeated over ``tile`` lanes and cut at ``n``. ``device`` defaults
    to the card (utils/device.py) and raises without one. No kernel
    stands behind it: it is ``tile_randoms_reference`` on ``device``."""
    return tile_randoms_reference(it_key, n, tile, with_rr, device)


def tile_randoms(it_key: np.ndarray, n: int, tile: int = 1024,
                 with_rr: bool = False, device="cuda"):
    """``tile_rows`` split as ``lane_randoms`` returns its rows."""
    return _split_rows(tile_rows(it_key, n, tile, with_rr, device), with_rr)


def bounce_randoms(ray_keys: torch.Tensor, bounce_idx: int,
                   with_rr: bool = False):
    """All randoms one bounce of the scan sampler needs (rng.py:42-72):
    ``lane_randoms`` with every lane on bounce ``bounce_idx`` and no
    sample fold (the sample is already in the key)."""
    bounce = torch.full((ray_keys.shape[1],), int(bounce_idx),
                        dtype=torch.int32, device=ray_keys.device)
    return lane_randoms(ray_keys, None, bounce, with_rr)
