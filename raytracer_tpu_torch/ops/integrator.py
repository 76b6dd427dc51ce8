"""Progressive frame integration: the megakernel and the wavefront samplers.

Port of ``raytracer_tpu/ops/integrator.py``. ``auto`` and ``mega`` take the
megakernel (ops/megakernel.py). The wavefront samplers hold the frame's
rays as (3, N) tensors and run one bounce of every lane per step:

- ``scan``: spp samples, each a fixed ``reflect_limit`` bounces with an
  alive mask (``_trace_soa``), the transcription of the reference's nested
  loops (src/raytracer.cu:71,102);
- ``regen``: one loop in which a lane whose path ends restarts on its
  pixel's next sample (``_render_regen_soa``);
- ``rebin`` / ``lanesort``: regen with the lanes regrouped by origin cell
  and direction octant after every bounce, by 128-lane rows or by ray
  (ops/rebin.py). Random streams are keyed by pixel and ride the
  permutation, and the pixel sums are un-permuted at the end, so both are
  bitwise equal to regen.

Randomness is keyed by the global pixel index ``ray_idx`` (the Renderer
passes its Morton order), sample and bounce (ops/rng.py). ``backend``
takes the JAX names: ``"pallas"`` (default) is the kernel route, K5 or K6
(ops/intersect_cuda.py) and ``rt_lane_randoms`` on a CUDA tensor, their
plain versions on a CPU tensor; ``"xla"`` and ``"woop"`` are the JAX
package's CPU oracles (ops/intersect.py). ``"plain"`` is the kernel route
with every kernel replaced by its plain version, on any device: the card
holds the kernel route against it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderSettings
from ..models.materials import MAT_EMISSIVE
from . import film, intersect, rng
from .intersect_cuda import WaveScene, hit_and_resolve
from .megakernel import MegaScene, render_sample_mean_mega
from .rebin import (LANES, apply_lane_permutation, bucket_permutation,
                    lane_buckets, lane_destinations, permute_rows,
                    row_buckets)
from .scatter import antialias_jitter, scatter
from .tables import lookup_material
from .textures import sample_texture

BACKENDS = ("pallas", "plain", "xla", "woop")
# The regen loop looks for its end every this many iterations: each look
# is a host sync on the card, and an iteration with no active lane changes
# nothing.
EXIT_CHECK_EVERY = 8
_PARK_ORIGIN = 1e13


def _bounce_physics(ws: WaveScene, settings: RenderSettings, backend: str,
                    sky, o, d, thru, rad, alive, cur_ior, jitter_u3, gauss,
                    fresnel_u, rr_u=None, bounces_done=None):
    """One bounce for all lanes (integrator.py:59-126). Returns (o, d,
    thru, rad, cur_ior, path_continues); ``sky`` is the (3, 1) sky colour
    on the rays' device. With ``rr_u``, russian roulette on paths past
    ``settings.russian_roulette`` bounces: survive with p =
    clamp(max(throughput), 0.05, 1), throughput divided by p."""
    scene = ws.scene
    if settings.antialias:
        d = antialias_jitter(jitter_u3, d)

    if backend in ("pallas", "plain"):
        rec, shade = hit_and_resolve(ws, o, d,
                                     need_sphere_uv=scene.needs_sphere_uv,
                                     plain=backend == "plain")
    else:
        rec = intersect.nearest_hit(o, d, scene, backend=backend)
        shade = intersect.resolve_hit(o, d, scene, rec)

    # a miss adds the sky and ends the path (src/raytracer.cu:76-80)
    miss = alive & ~rec.hit
    rad = rad + torch.where(miss[None, :], thru * sky, 0.0)

    cols = lookup_material(scene, shade.mat_id)
    is_emissive = cols.mat_type == MAT_EMISSIVE
    live_hit = alive & rec.hit
    # emission adds, else the throughput takes the texture colour
    # (src/raytracer.cu:86-90)
    rad = rad + torch.where((live_hit & is_emissive)[None, :],
                            thru * cols.emit, 0.0)
    tex = sample_texture(scene, cols, shade.u, shade.v, shade.colour)
    thru = torch.where((live_hit & ~is_emissive)[None, :], thru * tex, thru)

    new_d, new_ior = scatter(
        gauss, fresnel_u, d, shade.normal, cols.mat_type, shade.smooth,
        cols.ior, cur_ior, fix_exit_ior=settings.fix_exit_ior,
        has_refractive=bool(scene.has_refractive))
    o = torch.where(live_hit[None, :], shade.point, o)
    d = torch.where(live_hit[None, :], new_d, d)
    cur_ior = torch.where(live_hit, new_ior, cur_ior)

    path_continues = live_hit
    if settings.emissive_terminates:
        path_continues = path_continues & ~is_emissive
    if rr_u is not None:
        p = torch.clamp(thru.amax(dim=0), 0.05, 1.0)
        eligible = path_continues & (
            bounces_done + 1 >= settings.russian_roulette)
        survive = rr_u < p
        thru = torch.where((eligible & survive)[None, :], thru / p[None, :],
                           thru)
        path_continues = path_continues & ~(eligible & ~survive)
    return o, d, thru, rad, cur_ior, path_continues


def _sky(settings: RenderSettings, dev) -> torch.Tensor:
    return torch.tensor(settings.sky_colour, dtype=torch.float32,
                        device=dev)[:, None]


def _trace_soa(ws: WaveScene, settings: RenderSettings, ray_idx, o, d,
               key: np.ndarray, backend: str):
    """One sample for every (3, N) ray: ``reflect_limit`` bounces with an
    alive mask (integrator.py:148-187). Returns ((3, N) radiance, int64
    count of live segments)."""
    ray_keys = rng.per_ray_keys(key, ray_idx)
    use_rr = settings.russian_roulette > 0
    sky = _sky(settings, o.device)
    thru = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones(o.shape[1], dtype=torch.bool, device=o.device)
    cur_ior = torch.ones(o.shape[1], dtype=torch.float32, device=o.device)
    segs = torch.zeros((), dtype=torch.int64, device=o.device)
    for bounce_i in range(settings.reflect_limit):
        segs = segs + alive.sum()
        drawn = rng.bounce_randoms(ray_keys, bounce_i, use_rr,
                                   plain=backend == "plain")
        o, d, thru, rad, cur_ior, alive = _bounce_physics(
            ws, settings, backend, sky, o, d, thru, rad, alive, cur_ior,
            *drawn[:3], rr_u=drawn[3] if use_rr else None,
            bounces_done=bounce_i)
    return rad, segs


def _render_regen_soa(ws: WaveScene, settings: RenderSettings, ray_idx,
                      o0, d0, frame_key: np.ndarray, backend: str,
                      rebin: bool = False, lane_sort: bool = False):
    """Path-regeneration sampler (integrator.py:190-366): each lane owns
    one pixel and restarts on the pixel's next sample when its path ends.
    Returns ((3, N) mean, int64 segments)."""
    spp = settings.rays_per_pixel
    limit = settings.reflect_limit
    n = o0.shape[1]
    dev = o0.device
    use_rr = settings.russian_roulette > 0
    sky = _sky(settings, dev)
    lane_sort = bool(lane_sort) and n % LANES == 0 and n // LANES >= 8
    rebin = (bool(rebin) and not lane_sort
             and n % LANES == 0 and n // LANES >= 8)
    carries_keys = rebin or lane_sort

    kd = rng.per_ray_keys(frame_key, ray_idx)
    o, d = o0, d0
    o0p, d0p = o0, d0
    thru = torch.ones_like(o0)
    rad = torch.zeros_like(o0)
    pixel_sum = torch.zeros_like(o0)
    bounce_i = torch.zeros(n, dtype=torch.int32, device=dev)
    sample_i = torch.zeros(n, dtype=torch.int32, device=dev)
    cur_ior = torch.ones(n, dtype=torch.float32, device=dev)
    home = (torch.arange(n if lane_sort else n // LANES, dtype=torch.int64,
                         device=dev) if carries_keys else None)
    park_d = torch.tensor([1.0, 0.0, 0.0], device=dev)[:, None]
    segs = torch.zeros((), dtype=torch.int64, device=dev)

    it = 0
    while it < spp * limit:
        if it % EXIT_CHECK_EVERY == 0 and not bool((sample_i < spp).any()):
            break
        it += 1
        active = sample_i < spp
        segs = segs + active.sum()
        drawn = rng.lane_randoms(kd, sample_i, bounce_i, use_rr,
                                 plain=backend == "plain")
        o, d, thru, rad, cur_ior, continues = _bounce_physics(
            ws, settings, backend, sky, o, d, thru, rad, active, cur_ior,
            *drawn[:3], rr_u=drawn[3] if use_rr else None,
            bounces_done=bounce_i)

        # a path ends on a miss or termination, or at the bounce limit
        path_end = active & (~continues | (bounce_i + 1 >= limit))
        pixel_sum = pixel_sum + torch.where(path_end[None, :], rad, 0.0)

        # regenerate finished lanes onto their next sample
        sample_i = torch.where(path_end, sample_i + 1, sample_i)
        bounce_i = torch.where(path_end, 0,
                               torch.where(active, bounce_i + 1, bounce_i))
        restart = path_end[None, :]
        o = torch.where(restart, o0p, o)
        d = torch.where(restart, d0p, d)
        thru = torch.where(restart, 1.0, thru)
        rad = torch.where(restart, 0.0, rad)
        cur_ior = torch.where(path_end, 1.0, cur_ior)

        if carries_keys:
            # park exhausted lanes far away, pointing at nothing
            done = sample_i >= spp
            o = torch.where(done[None, :], _PARK_ORIGIN, o)
            d = torch.where(done[None, :], park_d, d)
        if lane_sort:
            dest = lane_destinations(lane_buckets(o, d, done))
            (o, d, thru, rad, pixel_sum, o0p, d0p, cur_ior, kd, bounce_i,
             sample_i, home) = apply_lane_permutation(
                dest, (o, d, thru, rad, pixel_sum, o0p, d0p, cur_ior, kd,
                       bounce_i, sample_i, home))
        elif rebin:
            perm = bucket_permutation(row_buckets(o, d, done))
            (o, d, thru, rad, pixel_sum, o0p, d0p, kd, bounce_i, sample_i,
             cur_ior) = (permute_rows(perm, a) for a in (
                 o, d, thru, rad, pixel_sum, o0p, d0p, kd, bounce_i,
                 sample_i, cur_ior))
            home = home[perm]

    if lane_sort:
        # home[current lane] = original lane
        out = torch.empty_like(pixel_sum)
        out[:, home] = pixel_sum
        pixel_sum = out
    elif rebin:
        unperm = torch.empty_like(home)
        unperm[home] = torch.arange(home.shape[0], device=dev)
        pixel_sum = permute_rows(unperm, pixel_sum)
    spp_t = torch.tensor(float(spp), dtype=torch.float32, device=dev)
    return pixel_sum / spp_t, segs


def render_sample_mean(scene, settings: RenderSettings, o: torch.Tensor,
                       d: torch.Tensor, frame_key: np.ndarray,
                       tile_offset: int = 0, ray_idx=None,
                       backend: str = "pallas"):
    """Mean of ``rays_per_pixel`` paths per primary ray
    (src/raytracer.cu:97-107). ``o``/``d`` are (N, 3); returns ((N, 3)
    mean, segment count as a float64 0-dim tensor).

    ``scene``: a SceneArrays, or the holder the sampler reads (MegaScene
    for ``auto``/``mega``, WaveScene for the wavefront samplers), built
    once per scene. ``ray_idx``: (N,) global pixel indices that key the
    wavefront streams (default 0..N-1). ``tile_offset`` globalises the
    megakernel's tile ids; the wavefront streams are keyed by pixel.

    ``auto`` and ``mega`` take the megakernel, for every scene. The JAX
    ``auto`` sends two kinds of scene to its wavefront pipeline instead:
    image planes past 2048 packed rows and scenes over the TPU's SMEM
    budget (megakernel.py:166-206). Both thresholds were measured on the
    TPU, whose kernel keeps scene and texels in on-chip memory; a thread
    on the card reads both from global memory, so neither cliff is
    carried over."""
    if settings.sampler in ("auto", "mega"):
        ms = scene if isinstance(scene, MegaScene) else MegaScene(scene)
        mean, segs = render_sample_mean_mega(ms, settings, o.T, d.T,
                                             frame_key,
                                             tile_offset=tile_offset)
        return mean.T, segs
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")
    ws = scene if isinstance(scene, WaveScene) else WaveScene(scene)
    n = o.shape[0]
    if ray_idx is None:
        ray_idx = torch.arange(n, dtype=torch.int32, device=o.device)
    o3, d3 = o.T.contiguous(), d.T.contiguous()
    if settings.sampler in ("regen", "rebin", "lanesort"):
        mean, segs = _render_regen_soa(
            ws, settings, ray_idx, o3, d3, frame_key, backend,
            rebin=settings.sampler == "rebin",
            lane_sort=settings.sampler == "lanesort")
    else:
        total = torch.zeros_like(o3)
        segs = torch.zeros((), dtype=torch.int64, device=o.device)
        for s in range(settings.rays_per_pixel):
            rad, n_segs = _trace_soa(ws, settings, ray_idx, o3, d3,
                                     rng.sample_key(frame_key, s), backend)
            total = total + rad
            segs = segs + n_segs
        spp_t = torch.tensor(float(settings.rays_per_pixel),
                             dtype=torch.float32, device=o.device)
        mean = total / spp_t
    return mean.T, segs.to(torch.float64)


def render_frame(scene, settings: RenderSettings, o: torch.Tensor,
                 d: torch.Tensor, accum: torch.Tensor, frame_num: int,
                 base_key: np.ndarray, tile_offset: int = 0, ray_idx=None,
                 backend: str = "pallas"):
    """One progressive frame: ``accum`` becomes the running mean of all
    frames so far, updated in place (src/raytracer.cu:109-113).
    Returns (accum, traced segment count)."""
    fkey = rng.frame_key(base_key, frame_num)
    mean, segs = render_sample_mean(scene, settings, o, d, fkey,
                                    tile_offset=tile_offset,
                                    ray_idx=ray_idx, backend=backend)
    return film.progressive_update(accum, mean, frame_num), segs
