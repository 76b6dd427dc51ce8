"""The wavefront iteration's ray set-up before K5 / K6: ``rt_wave_rays``.

In the JAX package XLA fuses, around the Pallas hit kernel inside the
jitted loop, what a wavefront iteration does before the hit: the lane's
draw (raytracer_tpu/ops/rng.py:75-101, or coherent sampling's tile draw,
:104-127), the antialias jitter (ops/scatter.py:34) and the normalisation
of the traced direction (ops/intersect_pallas.py:728-741). Here that is
one CUDA kernel, ``rt_wave_rays`` (csrc/rays.cu): per lane it draws in
registers (in the coherent arm: its tile's bundle, drawn once a block),
jitters and renormalises the direction, normalises it again for the hit
kernel and writes what K5 / K6 and ``rt_wave_bounce`` read: the traced
direction ``dj``, its unit direction and 1 / |dj|, and the Gaussian,
Fresnel and russian-roulette draws. The jitter rows stay in registers.
A finished regen lane (``sample_i >= spp``) draws nothing: it gets the
unit direction ``PARK_UNIT`` and 1 / |dj| = 1, which K5 / K6 walk from
the park origin ``rt_wave_bounce`` moved it to where they are launched
without the regen loop's mask (with it they skip the lane), and its
``dj`` and draws are left unwritten.
It also adds the iteration's traced segments to a counter in device
memory and, under a replayed CUDA graph, advances the coherent draw's
iteration counter there: a coherent iteration is three kernels, as a
per-lane one is.

``wave_rays_reference`` is its plain version, the composition it replaced:
``rng.lane_randoms_reference`` (or the tile draw's rows,
``rng.tile_randoms_reference``, which the kernel no longer reads from
device memory), then ``scatter.antialias_jitter``, then
``intersect_cuda.unit_rays``. CPU tensors, or ``plain=True`` on any
device, take it; on a CUDA tensor ``wave_rays`` launches the kernel or
raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ANTIALIAS_OFFSET_RANGE
from ..kernels import build
from .intersect_cuda import unit_rays
from .rng import (fold_in_tensor, key_data, lane_randoms_reference,
                  tile_randoms_reference)
from .scatter import antialias_jitter

# the jitter's scale as the float32 scalar torch multiplies by
JITTER_SCALE = float(np.float32(2.0 * ANTIALIAS_OFFSET_RANGE))
# The coherent draw's lanes a tile: rng.tile_randoms' default, the tile the
# JAX wavefront loop draws with (raytracer_tpu/ops/integrator.py:266), and
# csrc/rays.cu's kCoherentTile.
TILE = 1024
# A finished lane's unit direction (csrc/rays.cu kParkUnit): from the park
# origin away from the scene and along no axis, since a zero component
# sends the hit kernels' triangle division by zero on every triangle
# parallel to it, IEEE division's slow path. Its squares sum to 1 in
# float32.
PARK_UNIT = (0.6, 0.64, 0.48)


@dataclasses.dataclass
class WaveRays:
    """One iteration's rays and draws, (3, N) or (N,) float32: ``dj`` the
    direction traced (jittered, or the lanes' own with antialias off),
    ``unit`` its unit direction and ``inv_len`` 1 / |dj| (what K5 / K6
    trace, and what turns their t back into ``dj``'s), ``gauss``,
    ``fresnel`` and ``rr`` (None without russian roulette) the draws the
    bounce reads."""

    dj: torch.Tensor
    unit: torch.Tensor
    inv_len: torch.Tensor
    gauss: torch.Tensor
    fresnel: torch.Tensor
    rr: torch.Tensor = None


def _finished(alive, sample_i, spp):
    """The finished regen lanes, ``sample_i >= spp`` ((N,) bool), or None:
    an alive mask, no sample or no ``spp`` finishes no lane."""
    if alive is not None or sample_i is None or spp is None:
        return None
    return sample_i >= spp


def _check_count(segs, alive, sample_i, spp) -> None:
    if segs is not None and alive is None and (sample_i is None
                                               or spp is None):
        raise ValueError("counting segments needs alive, or sample_i and "
                         "spp")


def _count(segs, alive, done) -> None:
    """Add the lanes that trace a segment to ``segs``: ``alive``'s, else
    those not ``done``."""
    if segs is not None:
        segs.add_((alive if alive is not None else ~done).sum())


def _tile_rows(n, with_rr, tile_key, key_dev, iter_dev, device):
    """The plain tile draw: the rows under ``tile_key``, or under the fold
    of ``key_dev`` with ``iter_dev[0]``, which then advances by one, as
    the kernel's last block advances it."""
    if tile_key is None:
        tile_key = np.array(fold_in_tensor(key_dev, iter_dev[:1]).tolist(),
                            np.uint32)
        iter_dev[:1].add_(1)
    return tile_randoms_reference(tile_key, n, TILE, with_rr, device)


def wave_rays_reference(d: torch.Tensor, *, keys=None, sample_i=None,
                        bounce=0, tile_key=None, key_dev=None,
                        iter_dev=None, antialias: bool = True,
                        with_rr: bool = False, segs=None, alive=None,
                        spp=None) -> WaveRays:
    """Plain version of ``rt_wave_rays`` (arguments as ``wave_rays``): a
    finished lane's ``dj`` and draws are computed as a live lane's, which
    the kernel leaves unwritten."""
    done = _finished(alive, sample_i, spp)
    _count(segs, alive, done)
    if keys is not None:
        if not isinstance(bounce, torch.Tensor):
            bounce = torch.full((d.shape[1],), int(bounce),
                                dtype=torch.int32, device=d.device)
        drawn = lane_randoms_reference(keys, sample_i, bounce, with_rr)
    else:
        drawn = _tile_rows(d.shape[1], with_rr, tile_key, key_dev,
                           iter_dev, d.device)
    dj = antialias_jitter(drawn[0:3], d) if antialias else d
    unit, inv_len = unit_rays(dj)
    if done is not None:
        park = torch.tensor(PARK_UNIT, device=d.device)[:, None]
        unit = torch.where(done[None, :], park, unit)
        inv_len = torch.where(done, 1.0, inv_len)
    return WaveRays(dj, unit, inv_len, drawn[3:6], drawn[6],
                    drawn[7] if with_rr else None)


def _ptr(x, dtype, shape, what: str) -> int:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {shape} {dtype} "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    return x.data_ptr()


def _rows3(x: torch.Tensor) -> list:
    """Row pointers of a contiguous (3, N) tensor."""
    return [x[i].data_ptr() for i in range(3)]


def rays_args(d, out: WaveRays, draws, *, keys=None, sample_i=None,
              bounce=0, tile_key=None, key_dev=None, iter_dev=None,
              antialias=True, with_rr=False, segs=None, alive=None,
              spp=None):
    """``rt_wave_rays``' argument struct: inputs as ``wave_rays`` (the
    per-lane ``keys`` or the tile key), outputs ``out``'s tensors and
    ``draws`` (the (rows - 3, N) buffer ``out``'s draws view). Checks what
    the kernel reads; the caller keeps the tensors alive across the
    launch."""
    _check_count(segs, alive, sample_i, spp)
    n = d.shape[1]
    rows = 8 if with_rr else 7
    a = build.RaysArgs()
    a.draws = _ptr(draws, torch.float32, (rows - 3, n), "draws")
    if keys is not None:
        a.keys = _ptr(keys, torch.int64, (2, n), "keys")
    elif tile_key is not None:
        kd = key_data(tile_key)
        a.key0, a.key1 = int(kd[0]), int(kd[1])
    else:
        a.key_dev = _ptr(key_dev, torch.int64, (2,), "key_dev")
        a.iter_dev = _ptr(iter_dev, torch.int64, (2,), "iter_dev")
    if sample_i is not None:
        a.sample = _ptr(sample_i, torch.int32, (n,), "sample_i")
    if isinstance(bounce, torch.Tensor):
        a.bounce = _ptr(bounce, torch.int32, (n,), "bounce")
    else:
        a.bounce_const = int(bounce)
    _ptr(d, torch.float32, (3, n), "d")
    a.d[:] = _rows3(d)
    if antialias:
        a.dj[:] = _rows3(out.dj)
    a.unit[:] = _rows3(out.unit)
    a.inv_len = _ptr(out.inv_len, torch.float32, (n,), "inv_len")
    if segs is not None:
        a.segs = _ptr(segs, torch.int64, (), "segs")
        if alive is not None:
            a.alive = _ptr(alive, torch.bool, (n,), "alive")
    a.n, a.rows, a.antialias = n, rows, int(antialias)
    # without spp no lane is finished
    a.spp = np.iinfo(np.int32).max if spp is None else int(spp)
    a.jitter_scale = JITTER_SCALE
    return a


def _wave_rays_cuda(d, **kw) -> WaveRays:
    """Launch rt_wave_rays (``wave_rays``' arguments) into new tensors."""
    n, dev = d.shape[1], d.device
    rows = 8 if kw["with_rr"] else 7
    kw = {k: x.contiguous() if isinstance(x, torch.Tensor) and k not in (
        "key_dev", "iter_dev") else x for k, x in kw.items()}
    d = d.contiguous()
    draws = torch.empty((rows - 3, n), dtype=torch.float32, device=dev)
    out = WaveRays(
        torch.empty_like(d) if kw["antialias"] else d, torch.empty_like(d),
        torch.empty(n, dtype=torch.float32, device=dev), draws[0:3],
        draws[3], draws[4] if rows == 8 else None)
    build.launch("rt_wave_rays", rays_args(d, out, draws, **kw), dev)
    return out


def wave_rays(d: torch.Tensor, *, keys=None, sample_i=None, bounce=0,
              tile_key=None, key_dev=None, iter_dev=None,
              antialias: bool = True, with_rr: bool = False, segs=None,
              alive=None, spp=None, plain: bool = False) -> WaveRays:
    """One wavefront iteration's ray set-up for the lanes' directions
    ``d`` ((3, N) float32, rows contiguous).

    The draw, one of:
    - ``keys`` ((2, N) int64, ``rng.per_ray_keys``) folded with
      ``sample_i`` ((N,) int32, or None: the key holds the sample, as
      ``rng.bounce_randoms``) and ``bounce`` ((N,) int32, or one int for
      every lane), as ``rng.lane_randoms``;
    - coherent sampling's tile draw, one bundle per ``TILE`` lanes, as
      ``rng.tile_rows``: under ``tile_key`` (a key), or under
      ``fold_in(key_dev, iter_dev[0])`` with ``key_dev`` ((2,) int64 key
      words) and ``iter_dev`` ((2,) int64: the iteration counter and a
      ticket word that each launch leaves zero) in device memory, read
      when the kernel runs, which adds one to the counter (a replayed
      CUDA graph's iterations each draw under their own key).
    ``antialias``: jitter ``d`` (else it is traced as it is); ``with_rr``:
    draw the russian-roulette row. ``segs`` (a 0-dim int64 tensor, or
    None) gets the lanes that trace a segment added: those of ``alive``
    ((N,) bool), else those with ``sample_i < spp``. Without ``alive``, a
    lane with ``sample_i >= spp`` (an int, or None: no lane) is finished:
    its ``unit`` is ``PARK_UNIT`` and its ``inv_len`` 1, and its ``dj``
    and draws are unspecified (the kernel writes neither).

    CPU tensors, or ``plain=True`` on any device, take
    ``wave_rays_reference``; CUDA tensors launch ``rt_wave_rays`` (or
    raise)."""
    given = [x is not None for x in (keys, tile_key, key_dev)]
    if sum(given) != 1 or (key_dev is None) != (iter_dev is None):
        raise ValueError("give one of keys, tile_key and key_dev (with "
                         "iter_dev)")
    if d.dtype != torch.float32 or d.dim() != 2 or d.shape[0] != 3:
        raise ValueError(f"d must be (3, N) float32, got {tuple(d.shape)} "
                         f"{d.dtype}")
    if iter_dev is not None and (iter_dev.dtype != torch.int64
                                 or iter_dev.shape != (2,)):
        raise ValueError(f"iter_dev must be (2,) int64 (the counter and "
                         f"its ticket), got {tuple(iter_dev.shape)} "
                         f"{iter_dev.dtype}")
    if key_dev is not None and not (key_dev.device == iter_dev.device
                                    == d.device):
        raise ValueError(f"key_dev and iter_dev must be on d's device "
                         f"{d.device}, got {key_dev.device} and "
                         f"{iter_dev.device}")
    _check_count(segs, alive, sample_i, spp)
    kw = dict(keys=keys, sample_i=sample_i, bounce=bounce,
              tile_key=tile_key, key_dev=key_dev, iter_dev=iter_dev,
              antialias=antialias, with_rr=with_rr, segs=segs,
              alive=alive, spp=spp)
    if d.device.type == "cpu" or plain:
        return wave_rays_reference(d, **kw)
    if d.device.type != "cuda":
        raise ValueError(f"no ray set-up for device {d.device}")
    return _wave_rays_cuda(d, **kw)
