"""Ray re-binning between bounces, for the rebin and lanesort samplers.

Port of ``raytracer_tpu/ops/rebin.py``. Rays are regrouped by (coarse
origin cell, direction octant) so that neighbouring lanes sweep the same
clusters: ``rebin`` moves whole 128-lane rows, ``lanesort`` single rays.
The JAX package builds both permutations as counting sorts from one-hot
matmuls because a sort is slow on the TPU; on the card a stable
``torch.sort`` gives the same permutation (the tests hold it equal to a
stable argsort, as the JAX tests hold the counting sort).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .megakernel import _trunc_int

LANES = 128
GRID = 4                       # spatial cells per axis (rows)
NUM_BUCKETS = GRID ** 3 * 8    # cells x direction octants
LANE_GRID = 2                  # spatial cells per axis (rays)
LANE_BUCKETS = LANE_GRID ** 3 * 8
_BIG = 3e37


def _octant(dx, dy, dz) -> torch.Tensor:
    return ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
            + (dz < 0).to(torch.int32))


def _cells(pos: torch.Tensor, live: torch.Tensor, grid: int) -> torch.Tensor:
    """Cell id of each (3, K) position over the live positions' bounding
    box; XLA's truncating, saturating cast, then a clip."""
    lo = torch.where(live[None, :], pos, _BIG).amin(dim=1, keepdim=True)
    hi = torch.where(live[None, :], pos, -_BIG).amax(dim=1, keepdim=True)
    extent = torch.clamp(hi - lo, min=1e-6)
    cell = torch.clamp(_trunc_int((pos - lo) / extent * grid), 0, grid - 1)
    return (cell[0] * grid + cell[1]) * grid + cell[2]


def row_buckets(o: torch.Tensor, d: torch.Tensor,
                done: torch.Tensor) -> torch.Tensor:
    """Bucket id per 128-lane row from its mean origin and mean direction
    (rebin.py:40-67); rows whose lanes are all done do not stretch the
    bounding box."""
    rows = o.shape[1] // LANES
    dm = d.reshape(3, rows, LANES).mean(dim=2)
    om = o.reshape(3, rows, LANES).mean(dim=2)
    live_row = ~done.reshape(rows, LANES).all(dim=1)
    return _cells(om, live_row, GRID) * 8 + _octant(*dm)


def bucket_permutation(bucket: torch.Tensor) -> torch.Tensor:
    """``perm[new_row] = old_row``: rows stably sorted by bucket
    (rebin.py:70-89)."""
    return torch.sort(bucket, stable=True).indices


def lane_buckets(o: torch.Tensor, d: torch.Tensor,
                 done: torch.Tensor) -> torch.Tensor:
    """Bucket id per ray in [0, LANE_BUCKETS) (rebin.py:114-132); done
    rays do not stretch the bounding box and share one corner bucket."""
    return _cells(o, ~done, LANE_GRID) * 8 + _octant(*d)


def lane_destinations(key: torch.Tensor) -> torch.Tensor:
    """``dest[i]``: ray i's slot in key-sorted order, stable within equal
    keys (``lane_destinations``, rebin.py:135-171, as a stable sort)."""
    order = torch.sort(key, stable=True).indices
    dest = torch.empty_like(order)
    dest[order] = torch.arange(key.shape[0], device=key.device)
    return dest


def apply_lane_permutation(dest: torch.Tensor,
                           arrays: Sequence[torch.Tensor]) -> list:
    """``out[..., dest] = a`` for each (N,) or (k, N) tensor
    (rebin.py:174-219)."""
    out = []
    for a in arrays:
        moved = torch.empty_like(a)
        moved[..., dest] = a
        out.append(moved)
    return out


def permute_rows(perm: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Apply a row permutation to a tensor whose last axis is R * 128
    (rebin.py:222-230)."""
    r = perm.shape[0]
    shaped = arr.reshape(arr.shape[:-1] + (r, LANES))
    return shaped.index_select(-2, perm).reshape(arr.shape)
