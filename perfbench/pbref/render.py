"""Frames of the reference: a progressive film over many frames at
chosen lane slots of the megakernel's layout.

Layout: a tile is 4096 lane slots times K (pixpack) pixels; slot s of
tile t owns the ray array's positions ``t * 4096 * K + k * 4096 + s``,
k < K. Progressive frames take the rays in Morton pixel order; positions
past the last pixel are padding rays (o = 0, d = +x).
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera, mega, rng

TILE = mega.TILE


def pixpack(spp: int) -> int:
    """Pixels a lane: 8 up to 32 samples a pixel, else 1."""
    return 8 if spp <= 32 else 1


def lane_positions(tiles: torch.Tensor, slots: torch.Tensor, k: int):
    """(K, L) ray-array positions of lane slots (tiles, slots)."""
    kk = torch.arange(k, device=tiles.device, dtype=torch.int64)[:, None]
    return tiles[None] * (TILE * k) + kk * TILE + slots[None]


def lane_rays(pose: dict, width: int, height: int, pos: torch.Tensor,
              order, dtype):
    """(3, K, L) origins and unit directions at positions ``pos`` (K, L);
    ``order`` maps positions to row-major pixels. Also the pixel of each
    position (-1 for padding)."""
    n = width * height
    real = pos < n
    flat = pos.reshape(-1)
    idx = flat[flat < n]
    pix = torch.as_tensor(order, device=pos.device)[idx]
    o_r, d_r = camera.rays(pose, width, height, pix, torch.float32)
    o = torch.zeros((3, flat.shape[0]), dtype=torch.float32,
                    device=pos.device)
    d = torch.zeros_like(o)
    d[0] = 1.0
    keep = (flat < n).nonzero()[:, 0]
    o[:, keep] = o_r.T
    d[:, keep] = d_r.T
    d = camera.unit(d)
    shape = (3,) + tuple(pos.shape)
    pixels = torch.full(pos.shape, -1, dtype=torch.int64, device=pos.device)
    pixels[real] = pix
    return o.reshape(shape).to(dtype), d.reshape(shape).to(dtype), pixels


def progressive(sc, pose: dict, width: int, height: int, spp: int,
                limit: int, antialias: bool, sky, seed: int, frames: int,
                tiles, slots, k: int, dtype=torch.float32):
    """The progressive film after ``frames`` frames at the pixels of lane
    slots (tiles, slots): the running mean of every frame's mean, frame
    f keyed ``fold_in(key(seed), f)``. Returns (film (K, L, 3), pixels
    (K, L), -1 for padding)."""
    dev = tiles.device
    pos = lane_positions(tiles, slots, k)
    order = camera.morton_order(width, height)
    o0, d0, pixels = lane_rays(pose, width, height, pos, order, dtype)
    base = rng.key(seed)
    words = [rng.fold_in(base, f) for f in range(frames)]
    nl = tiles.shape[0]
    w0 = torch.tensor([w[0] for w in words], dtype=torch.int64,
                      device=dev).repeat_interleave(nl)
    w1f = torch.tensor([w[1] for w in words], dtype=torch.int64,
                       device=dev).repeat_interleave(nl)
    w1 = rng.tile_w1(w1f, tiles.repeat(frames))
    mean, _ = mega.lanes(sc, o0.repeat(1, 1, frames), d0.repeat(1, 1, frames),
                         w0, w1, slots.repeat(frames), spp=spp, limit=limit,
                         antialias=antialias, sky=sky)
    mean = mean.reshape(3, k, frames, nl)
    film = torch.zeros((k, nl, 3), dtype=dtype, device=dev)
    for f in range(frames):
        fn = float(f)
        film = film.mul(fn).add(mean[:, :, f].permute(1, 2, 0)).div(fn + 1.0)
    return film, pixels


def choose_lanes(seed: int, n_pixels: int, k: int, count: int, device):
    """``count`` distinct lane slots drawn from the seed, over the tiles
    that hold real pixels: (tiles, slots) int64."""
    n_tiles = -(-n_pixels // (TILE * k))
    total = n_tiles * TILE
    g = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                               0x51EC7])
    lanes = np.sort(g.choice(total, size=min(count, total), replace=False))
    lanes = torch.as_tensor(lanes, dtype=torch.int64, device=device)
    return lanes // TILE, lanes % TILE
