"""raytracer_tpu_torch's fused wavefront bounce (ops/bounce.py) and the
wavefront loop as the card replays it (ops/integrator.py,
ops/wave_graph.py), on the CPU.

- ``wave_bounce_reference`` on K5's raw outputs against the port's
  resolve and bounce as the integrator composed them before
  ``rt_wave_bounce`` and ``rt_wave_rays`` existed (``_todays_*`` below,
  kept as they were, the oracle): bitwise, on scenes 1-4, the 256x512
  earth (sphere UV on) and a gradient scene, in the scan and the regen
  arm, with russian roulette on and off and with ``fix_exit_ior`` and
  ``emissive_terminates`` (K6's raw outputs: test_torch_wave_rays.py).
- The samplers as refactored against that composition's renders, bitwise,
  and against JAX's ``render_sample_mean`` with its Pallas kernel in
  interpret mode within test_torch_wavefront.py's bounds (scene 1).
- The coherent draw's device-side key: ``fold_in_tensor`` is bitwise
  ``rng.fold_in`` over ``it`` = 0..99.
- The graph route simulated without a card: ``wave_graph.capture`` is
  replaced by a stub whose replay runs the captured body eagerly, so the
  static state, the in-place updates, the device-side keys, the cache key
  and the launch accounting run here, held bitwise against the eager
  route. The card tests (tests/test_torch_cuda.py) replay real graphs.
- The repair: ``tile_randoms`` and ``tile_randoms_reference`` default to
  the card and raise without one.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.ops.integrator import render_sample_mean as jrsm
from raytracer_tpu_torch.models import camera as tcam
from raytracer_tpu_torch.models.materials import MAT_EMISSIVE, Material, \
    Texture
from raytracer_tpu_torch.models.scene import SceneBuilder
from raytracer_tpu_torch.models.scenes import procedural_earth_texture
from raytracer_tpu_torch.ops import bounce as tb
from raytracer_tpu_torch.ops import integrator as tint
from raytracer_tpu_torch.ops import intersect as tisect
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.ops import wave_graph as twg
from raytracer_tpu_torch.ops import intersect_cuda as tic
from raytracer_tpu_torch.ops.intersect import HitRecord, ShadeData
from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
from raytracer_tpu_torch.ops.sweep import INF
from raytracer_tpu_torch.ops.rebin import (LANES, apply_lane_permutation,
                                           bucket_permutation, lane_buckets,
                                           lane_destinations, permute_rows,
                                           row_buckets)
from raytracer_tpu_torch.ops.scatter import antialias_jitter, scatter
from raytracer_tpu_torch.ops.tables import lookup_material
from raytracer_tpu_torch.ops.textures import sample_texture
from raytracer_tpu_torch.utils import trace
from test_torch_wavefront import PIXEL_ABS, PIXEL_BOUNDS, SEGS_REL

torch.set_num_threads(2)

# camera position per scene (scenes 1-3 and the gradient scene sit in
# front of the origin, scene 4's camera is moved back)
POS = {1: (0.0, 0.0, 0.0), 2: (0.0, 0.0, 0.0), 3: (0.0, 0.0, 0.0),
       4: (0.0, 0.5, -6.0), "gradient": (0.0, 0.0, 0.0),
       "earth": (0.0, 0.0, 0.0)}
VARIANTS = {"base": {}, "rr": {"russian_roulette": 1},
            "fix_emissive": {"fix_exit_ior": True,
                             "emissive_terminates": True}}


# -- the port's bounce and samplers as they were composed before -------------

def _todays_unit_rays(o, d):
    n = o.shape[1]
    n_pad = max(4096, -(-n // 4096) * 4096)
    if n_pad != n:
        pad_d = torch.zeros((3, n_pad - n), dtype=d.dtype, device=d.device)
        pad_d[0] = 1.0
        o = torch.cat([o, torch.zeros_like(pad_d)], dim=1)
        d = torch.cat([d, pad_d], dim=1)
    inv_len = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return o.contiguous(), (d * inv_len[None, :]).contiguous(), inv_len


def _todays_hit_and_resolve(ws, o, d, need_sphere_uv=True, plain=False):
    n = o.shape[1]
    o_p, d_u, inv_len = _todays_unit_rays(o, d)
    outs = [x[:n] for x in tic.hit_resolve_unit(ws, o_p, d_u, plain)]
    t = outs[0]
    outs[0] = torch.where(t < INF, t * inv_len[:n], INF)
    (t, code, u, v, n0, n1, n2, mat_id, colr, colg, colb, smooth) = outs
    hit = t < INF
    is_tri = (code & 1) == 1
    rec = HitRecord(t=t, hit=hit, is_tri=is_tri, idx=code >> 1)
    safe_t = torch.where(hit, t, 0.0)
    point = o + d * safe_t[None, :]
    relx, rely, relz = point[0] - n0, point[1] - n1, point[2] - n2
    rmag = torch.rsqrt(torch.clamp(relx * relx + rely * rely + relz * relz,
                                   min=1e-24))
    sph_n = (relx * rmag, rely * rmag, relz * rmag)
    if need_sphere_uv:
        theta = torch.asin(torch.clamp(sph_n[1], -1.0, 1.0))
        phi = torch.acos(torch.clamp(sph_n[0], -1.0, 1.0))
        sph_u = (theta + torch.pi / 2.0) / torch.pi
        v_ratio = (1.0 - phi / torch.pi) / 2.0
        behind = (point[2] > n2).to(torch.float32)
        sph_v = behind + (1.0 - 2.0 * behind) * v_ratio
    else:
        sph_u = torch.zeros_like(u)
        sph_v = torch.zeros_like(v)
    n_dot_d = n0 * d[0] + n1 * d[1] + n2 * d[2]
    flip = 1.0 - 2.0 * (n_dot_d > 0.0).to(torch.float32)
    normal = torch.stack([torch.where(is_tri, n0 * flip, sph_n[0]),
                          torch.where(is_tri, n1 * flip, sph_n[1]),
                          torch.where(is_tri, n2 * flip, sph_n[2])])
    shade = ShadeData(point=point, normal=normal,
                      u=torch.where(is_tri, u, sph_u),
                      v=torch.where(is_tri, v, sph_v), mat_id=mat_id,
                      colour=torch.stack([colr, colg, colb]), smooth=smooth)
    return rec, shade


def _todays_bounce(ws, settings, backend, sky, o, d, thru, rad, alive,
                   cur_ior, jitter_u3, gauss, fresnel_u, rr_u=None,
                   bounces_done=None):
    scene = ws.scene
    if settings.antialias:
        d = antialias_jitter(jitter_u3, d)
    if backend in ("pallas", "plain"):
        rec, shade = _todays_hit_and_resolve(
            ws, o, d, need_sphere_uv=scene.needs_sphere_uv,
            plain=backend == "plain")
    else:
        rec = tisect.nearest_hit(o, d, scene, backend=backend)
        shade = tisect.resolve_hit(o, d, scene, rec)
    miss = alive & ~rec.hit
    rad = rad + torch.where(miss[None, :], thru * sky, 0.0)
    cols = lookup_material(scene, shade.mat_id)
    is_emissive = cols.mat_type == MAT_EMISSIVE
    live_hit = alive & rec.hit
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


def _sky(settings):
    return torch.tensor(settings.sky_colour, dtype=torch.float32)[:, None]


def _todays_trace(ws, settings, ray_idx, o, d, key, backend):
    ray_keys = trng.per_ray_keys(key, ray_idx)
    use_rr = settings.russian_roulette > 0
    sky = _sky(settings)
    thru, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones(o.shape[1], dtype=torch.bool)
    cur_ior = torch.ones(o.shape[1], dtype=torch.float32)
    segs = torch.zeros((), dtype=torch.int64)
    for bounce_i in range(settings.reflect_limit):
        segs = segs + alive.sum()
        drawn = trng.bounce_randoms(ray_keys, bounce_i, use_rr)
        o, d, thru, rad, cur_ior, alive = _todays_bounce(
            ws, settings, backend, sky, o, d, thru, rad, alive, cur_ior,
            *drawn[:3], rr_u=drawn[3] if use_rr else None,
            bounces_done=bounce_i)
    return rad, segs


def _todays_regen(ws, settings, ray_idx, o0, d0, frame_key, backend,
                  rebin=False, lane_sort=False, tile_offset=0):
    spp, limit = settings.rays_per_pixel, settings.reflect_limit
    n = o0.shape[1]
    use_rr = settings.russian_roulette > 0
    sky = _sky(settings)
    lane_sort = bool(lane_sort) and n % LANES == 0 and n // LANES >= 8
    rebin = (bool(rebin) and not lane_sort
             and n % LANES == 0 and n // LANES >= 8)
    carries_keys = rebin or lane_sort
    tile_key = trng.fold_in(frame_key, tile_offset) if settings.coherent \
        else None
    kd = trng.per_ray_keys(frame_key, ray_idx)
    o, d, o0p, d0p = o0, d0, o0, d0
    thru, rad = torch.ones_like(o0), torch.zeros_like(o0)
    pixel_sum = torch.zeros_like(o0)
    bounce_i = torch.zeros(n, dtype=torch.int32)
    sample_i = torch.zeros(n, dtype=torch.int32)
    cur_ior = torch.ones(n, dtype=torch.float32)
    home = (torch.arange(n if lane_sort else n // LANES, dtype=torch.int64)
            if carries_keys else None)
    park_d = torch.tensor([1.0, 0.0, 0.0])[:, None]
    segs = torch.zeros((), dtype=torch.int64)
    it = 0
    while it < spp * limit:
        if it % 8 == 0 and not bool((sample_i < spp).any()):
            break
        it += 1
        active = sample_i < spp
        segs = segs + active.sum()
        if tile_key is not None:
            drawn = trng.tile_randoms(trng.fold_in(tile_key, it - 1), n,
                                      with_rr=use_rr, device="cpu")
        else:
            drawn = trng.lane_randoms(kd, sample_i, bounce_i, use_rr)
        o, d, thru, rad, cur_ior, continues = _todays_bounce(
            ws, settings, backend, sky, o, d, thru, rad, active, cur_ior,
            *drawn[:3], rr_u=drawn[3] if use_rr else None,
            bounces_done=bounce_i)
        path_end = active & (~continues | (bounce_i + 1 >= limit))
        pixel_sum = pixel_sum + torch.where(path_end[None, :], rad, 0.0)
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
            done = sample_i >= spp
            o = torch.where(done[None, :], 1e13, o)
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
        out = torch.empty_like(pixel_sum)
        out[:, home] = pixel_sum
        pixel_sum = out
    elif rebin:
        unperm = torch.empty_like(home)
        unperm[home] = torch.arange(home.shape[0])
        pixel_sum = permute_rows(unperm, pixel_sum)
    return pixel_sum / torch.tensor(float(spp)), segs


def _todays_mean(ws, settings, o, d, fkey, ray_idx, tile_offset=0):
    """render_sample_mean's wavefront branch as it was (kernel route)."""
    o3, d3 = o.T.contiguous(), d.T.contiguous()
    if settings.sampler != "scan":
        mean, segs = _todays_regen(
            ws, settings, ray_idx, o3, d3, fkey, "pallas",
            rebin=settings.sampler == "rebin",
            lane_sort=settings.sampler == "lanesort",
            tile_offset=tile_offset)
        return mean.T, segs.to(torch.float64)
    total = torch.zeros_like(o3)
    segs = torch.zeros((), dtype=torch.int64)
    for s in range(settings.rays_per_pixel):
        rad, n_segs = _todays_trace(ws, settings, ray_idx, o3, d3,
                                    trng.sample_key(fkey, s), "pallas")
        total, segs = total + rad, segs + n_segs
    return (total / torch.tensor(float(settings.rays_per_pixel))).T, \
        segs.to(torch.float64)


# -- helpers -----------------------------------------------------------------

def _gradient_scene():
    """A gradient-textured sphere and a checker floor under an emissive
    sphere: the texture branch scenes 1-4 do not reach."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 1.7), 0.3,
                 Material.standard(Texture.gradient(), 0.2))
    b.add_sphere((0.3, 0.35, 1.5), 0.1,
                 Material.emissive((1.0, 0.9, 0.8), 4))
    b.add_quad((-2, -0.3, 0), (2, -0.3, 0), (2, -0.3, 4), (-2, -0.3, 4),
               Material.standard(Texture.checkerboard((1, 1, 1), (0, 0, 0),
                                                      8), 0))
    return b.build(device="cpu"), True


def _scene(num):
    if num == "gradient":
        return _gradient_scene()
    if num == "earth":
        return rtt.build_scene(2, device="cpu",
                               earth_image=procedural_earth_texture(256))
    return rtt.build_scene(num, device="cpu",
                           **({"seed": 0} if num == 4 else {}))


def _rays(num, w=32, h=16):
    order = tcam.morton_order(w, h)
    o, d = tcam.primary_rays(tcam.build_camera(rtt.CameraConfig(
        width=w, height=h, position=POS[num])), w, h, pixel_order=order,
        device="cpu")
    return o, d, torch.as_tensor(order)


def _equal(got: dict, want: dict):
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# -- wave_bounce_reference against today's composition -----------------------

def todays_bounce_vs_reference(num, arm, variant, blocked=False):
    """Four bounces of 512 lanes, each held bitwise: ``wave_bounce_reference``
    on the raw outputs of K5 (K6 with ``blocked``), from the new ray set-up,
    against today's composition on today's draws: the scan arm against
    ``_todays_bounce``, the regen arm against it plus today's regeneration
    bookkeeping (the regen arm parks a lane as its last sample ends)."""
    from raytracer_tpu_torch.ops.rays import wave_rays
    scene, sky = _scene(num)
    settings = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                                  **VARIANTS[variant]).with_sky(sky)
    ws = WaveScene(scene, blocked=blocked)
    o, d, idx = _rays(num)
    o, d = o.T.contiguous(), d.T.contiguous()
    n = o.shape[1]
    keys = trng.per_ray_keys(trng.key(7), idx)
    use_rr = settings.russian_roulette > 0
    regen = arm == "regen"
    st = {"o": o, "d": d, "thru": torch.ones_like(o),
          "rad": torch.zeros_like(o),
          "cur_ior": torch.ones(n, dtype=torch.float32)}
    if regen:
        st.update(pixel_sum=torch.zeros_like(o), o0p=o, d0p=d,
                  sample_i=torch.zeros(n, dtype=torch.int32),
                  bounce_i=torch.zeros(n, dtype=torch.int32))
    else:
        st["alive"] = torch.ones(n, dtype=torch.bool)
    for b in range(4):
        if regen:
            drawn = trng.lane_randoms(keys, st["sample_i"], st["bounce_i"],
                                      use_rr)
            rays = wave_rays(st["d"], keys=keys, sample_i=st["sample_i"],
                             bounce=st["bounce_i"], with_rr=use_rr)
            alive = st["sample_i"] < settings.rays_per_pixel
        else:
            drawn = trng.bounce_randoms(keys, b, use_rr)
            rays = wave_rays(st["d"], keys=keys, bounce=b, with_rr=use_rr)
            alive = st["alive"]
        rr_u = drawn[3] if use_rr else None
        raw = tic.hit_raw(ws, st["o"], rays.unit)
        assert len(raw) == (9 if blocked else 12)
        got = tb.wave_bounce_reference(
            scene, settings, st, rays.dj, raw, rays.inv_len, rays.gauss,
            rays.fresnel, rays.rr, regen=regen, bounce=b)
        o2, d2, thru, rad, ior, cont = _todays_bounce(
            ws, settings, "pallas", _sky(settings), st["o"], st["d"],
            st["thru"], st["rad"], alive, st["cur_ior"], *drawn[:3],
            rr_u=rr_u, bounces_done=st["bounce_i"] if regen else b)
        want = {"o": o2, "d": d2, "thru": thru, "rad": rad, "cur_ior": ior}
        if regen:
            si, bi = st["sample_i"], st["bounce_i"]
            end = alive & (~cont | (bi + 1 >= settings.reflect_limit))
            restart = end[None, :]
            done = torch.where(end, si + 1, si) >= settings.rays_per_pixel
            want = {
                "pixel_sum": st["pixel_sum"] + torch.where(restart, rad,
                                                           0.0),
                "sample_i": torch.where(end, si + 1, si),
                "bounce_i": torch.where(end, 0, torch.where(alive, bi + 1,
                                                            bi)),
                "o": torch.where(done[None, :], 1e13,
                                 torch.where(restart, st["o0p"], o2)),
                "d": torch.where(done[None, :],
                                 torch.tensor([1.0, 0.0, 0.0])[:, None],
                                 torch.where(restart, st["d0p"], d2)),
                "thru": torch.where(restart, 1.0, thru),
                "rad": torch.where(restart, 0.0, rad),
                "cur_ior": torch.where(end, 1.0, ior)}
        else:
            want["alive"] = cont
        _equal(got, want)
        st.update(got)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arm", ["scan", "regen"])
@pytest.mark.parametrize("num", [1, 2, 3, 4, "gradient", "earth"])
def test_wave_bounce_reference_is_todays_bounce(num, arm, variant):
    """``wave_bounce_reference`` on K5's raw outputs is today's resolve
    and bounce (``todays_bounce_vs_reference``)."""
    todays_bounce_vs_reference(num, arm, variant)


# -- the samplers: today's renders, and JAX's --------------------------------

SAMPLER_CASES = [("regen", False), ("scan", False), ("rebin", False),
                 ("lanesort", False), ("regen", True), ("rebin", True),
                 ("lanesort", True)]


@pytest.mark.parametrize("sampler,coherent", SAMPLER_CASES)
def test_samplers_are_todays_renders(sampler, coherent):
    """render_sample_mean's kernel route (plain versions on the CPU) is
    bitwise the composition it replaced, scene 4 at 64x32 (16 lane rows:
    rebin and lanesort regroup), 3 spp, russian roulette from bounce 2,
    tile offset 2."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=2).with_sky(sky)
    o, d, idx = _rays(4, 64, 32)
    ws = WaveScene(scene)
    fkey = trng.frame_key(trng.key(1), 2)
    got = tint.render_sample_mean(ws, s, o, d, fkey, tile_offset=2,
                                  ray_idx=idx)
    want = _todays_mean(ws, s, o, d, fkey, idx, tile_offset=2)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


@pytest.mark.parametrize("sampler", ["regen", "scan", "rebin", "lanesort"])
def test_samplers_match_jax_interpret(sampler):
    """The port's kernel route (plain versions) against JAX's
    render_sample_mean on its Pallas kernel in interpret mode: scene 1 at
    32x32 (8 lane rows, so rebin and lanesort regroup), 2 spp, 3 bounces,
    within test_torch_wavefront.py's scene-1 bounds."""
    w, h = 32, 32
    js, sky = rt.build_scene(1)
    ts, _ = _scene(1)
    order = jcam.morton_order(w, h)
    jo, jd = jcam.primary_rays(jcam.build_camera(rt.CameraConfig(
        width=w, height=h)), w, h, pixel_order=order)
    kw = dict(rays_per_pixel=2, reflect_limit=3, sampler=sampler)
    jm, jsegs = jrsm(js, rt.RenderSettings(**kw).with_sky(sky),
                     jnp.asarray(order), jo, jd, jax.random.key(0),
                     backend="pallas")
    tm, tsegs = tint.render_sample_mean(
        ts, rtt.RenderSettings(**kw).with_sky(sky),
        torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd)),
        trng.key(0), ray_idx=torch.from_numpy(np.array(order)))
    err = np.abs(tm.numpy() - np.asarray(jm))
    share_min, mean_max = PIXEL_BOUNDS[1]
    assert (err.max(axis=1) <= PIXEL_ABS).mean() >= share_min
    assert err.mean() <= mean_max
    assert abs(float(tsegs) - float(jsegs)) <= \
        SEGS_REL[(1, "pallas")] * float(jsegs)


# -- the coherent draw's device-side key -------------------------------------

@pytest.mark.parametrize("seed", [0, 123456789])
def test_fold_in_tensor_is_fold_in(seed):
    """The plain version of the fold rt_wave_rays' coherent arm does on
    the card."""
    k = trng.fold_in(trng.key(seed), 4)
    kt = torch.tensor([int(w) for w in k], dtype=torch.int64)
    for it in range(100):
        got = trng.fold_in_tensor(kt, torch.tensor([it]))
        assert got.tolist() == [int(w) for w in trng.fold_in(k, it)]


def test_device_key_draws_are_the_host_key_draws():
    """``per_ray_keys`` from a key tensor is bitwise the numpy key's;
    ``set_key`` writes the words."""
    k = trng.fold_in(trng.key(3), 9)
    buf = torch.zeros(2, dtype=torch.int64)
    trng.set_key(buf, k)
    assert buf.tolist() == [int(w) for w in k]
    idx = torch.arange(300, dtype=torch.int32) * 7919
    assert torch.equal(trng.per_ray_keys(buf, idx),
                       trng.per_ray_keys(k, idx))


# -- the graph route without a card ------------------------------------------

class _EagerGraph:
    """Stands in for a captured CUDA graph: replay runs the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def eager_graphs(monkeypatch):
    """Route the kernel route's CPU tensors through the graph route, its
    captures replaced by ``_EagerGraph`` (a replay adds one launch of
    each kernel of the iteration); returns the list of captures,
    (id(ws), N)."""
    captured = []

    def capture(ws, n, body):
        captured.append((id(ws), n))
        return twg.Graph(_EagerGraph(body), collections.Counter(
            ("rt_wave_rays", "rt_hit_resolve", "rt_wave_bounce")))
    monkeypatch.setattr(tint, "_replays",
                        lambda backend, o: backend == "pallas")
    monkeypatch.setattr(twg, "capture", capture)
    return captured


@pytest.mark.parametrize("sampler,coherent", SAMPLER_CASES)
def test_graph_route_is_the_eager_route(eager_graphs, sampler, coherent):
    """The graph route's static state, in-place updates, device-side
    coherent key and iteration counter and its cache: two frames and a
    camera move through one WaveScene capture once per block size and
    give the eager route's frames bitwise. Scene 4, 64x32, 3 spp, 4
    bounces (12 iterations: a block of 8 and one of 4)."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=2).with_sky(sky)
    ws = WaveScene(scene)
    eager_ws = WaveScene(scene)
    for frame, pos in ((0, (0.0, 0.5, -6.0)), (1, (0.0, 0.5, -6.0)),
                       (2, (0.3, 0.6, -5.0))):
        order = tcam.morton_order(64, 32)
        o, d = tcam.primary_rays(tcam.build_camera(rtt.CameraConfig(
            width=64, height=32, position=pos)), 64, 32,
            pixel_order=order, device="cpu")
        idx = torch.as_tensor(order)
        fkey = trng.frame_key(trng.key(1), frame)
        got = tint.render_sample_mean(ws, s, o, d, fkey, tile_offset=2,
                                      ray_idx=idx)
        want = tint.render_sample_mean(eager_ws, s, o, d, fkey,
                                       tile_offset=2, ray_idx=idx,
                                       backend="plain")
        assert torch.equal(got[0], want[0])
        assert float(got[1]) == float(want[1])
    (runner,) = ws.graphs.values()
    assert not eager_ws.graphs
    if sampler == "scan":
        assert eager_graphs == [(id(ws), 2048)]
    else:
        # one capture per block size used: 8 iterations, then the rest
        assert set(runner.graphs) <= {8, 4} and 8 in runner.graphs
        assert eager_graphs == [(id(ws), 2048)] * len(runner.graphs)


def test_graph_cache_key(eager_graphs):
    """One capture per (kind, N, settings, backend): ``trace`` with the
    same settings replays the scan graph; another N, other settings or
    another WaveScene capture anew; an eager route captures nothing."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=3).with_sky(sky)
    ws = WaveScene(scene)
    o, d, idx = _rays(4)
    r1 = rtt.trace(ws, s, o, d, trng.key(2), ray_idx=idx)
    r2 = rtt.trace(ws, s, o, d, trng.key(2), ray_idx=idx)
    assert len(eager_graphs) == 1
    assert torch.equal(r1[0], r2[0]) and float(r1[1]) == float(r2[1])
    rtt.trace(ws, s, o[:256], d[:256], trng.key(2), ray_idx=idx[:256])
    rtt.trace(ws, dataclasses.replace(s, reflect_limit=2), o, d,
              trng.key(2), ray_idx=idx)
    rtt.trace(WaveScene(scene), s, o, d, trng.key(2), ray_idx=idx)
    assert len(eager_graphs) == 4 and len(ws.graphs) == 3
    rtt.trace(ws, s, o, d, trng.key(2), ray_idx=idx, backend="plain")
    assert len(eager_graphs) == 4
    want = rtt.trace(WaveScene(scene), s, o, d, trng.key(2), ray_idx=idx,
                     backend="plain")
    assert torch.equal(r1[0], want[0]) and float(r1[1]) == float(want[1])


def test_replay_adds_the_captured_launches(monkeypatch):
    """A capture counts the launches its body issued and takes them back
    off the program counts (a capture runs nothing); each replay adds them
    and one to ``graph.replay``; a body that raises leaves the counts as
    they were."""
    class _Stub:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

    class _Capturing:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    stub = _Stub()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: stub)
    monkeypatch.setattr(torch.cuda, "graph", _Capturing)
    monkeypatch.setattr(twg, "warm_up", lambda ws, n: None)
    iteration = ("rt_wave_rays", "rt_hit_resolve", "rt_wave_bounce")
    start = collections.Counter(
        {name: 10 for name in iteration + ("rt_hit_resolve_blocked",)})
    monkeypatch.setattr(trace, "_counts", start.copy())

    def body():
        for _ in range(8):
            for name in iteration:
                trace.count(name)
            trace.count("rt_hit_resolve.skip")
    g = twg.capture(None, 4096, body)
    assert trace.counts() == start + collections.Counter(
        {"graph.capture": 1})
    for _ in range(15):
        g.replay()
    c = trace.counts()
    assert stub.replays == 15 and c["graph.replay"] == 15
    assert [c[name] for name in iteration] == [130, 130, 130]
    assert c["rt_hit_resolve.skip"] == 120
    assert c["rt_hit_resolve_blocked"] == 10

    def bad():
        trace.count("rt_hit_resolve")
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        twg.capture(None, 4096, bad)
    assert trace.counts() == c


# -- the repair: the tile draws default to the card --------------------------

def test_tile_randoms_default_to_the_card(monkeypatch):
    """With no device both draws ask for the card, as build_scene does
    (utils/device.py), and raise where there is none; ``device="cpu"``
    draws on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = trng.key(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trng.tile_randoms(k, 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trng.tile_randoms_reference(k, 100)
    assert trng.tile_randoms(k, 100, device="cpu")[0].device.type == "cpu"


# -- finished lanes: kept, parked, counted -----------------------------------

def _by_lane(st: dict, sampler: str) -> dict:
    """The regen state indexed by original lane: rebin moves 128-lane rows
    (``home`` per row), lanesort lanes (``home`` per lane)."""
    n = st["o"].shape[1]
    if sampler == "lanesort":
        orig = st["home"]
    elif sampler == "rebin":
        orig = (st["home"][:, None] * LANES
                + torch.arange(LANES)[None, :]).reshape(-1)
    else:
        orig = torch.arange(n)
    pos = torch.empty_like(orig)
    pos[orig] = torch.arange(n)
    return {k: x[..., pos] for k, x in st.items()
            if k not in ("segs", "home")}


@pytest.mark.parametrize("sampler", ["regen", "rebin", "lanesort"])
def test_finished_lanes_keep_their_state(sampler):
    """The plain regen iteration, lane by lane (scene 4, 64x32: 16 rows,
    so rebin and lanesort regroup; 2 spp, 3 bounces, russian roulette): a
    lane that enters an iteration finished leaves it with every state row
    as it was; a lane that finishes in it is parked (``PARK_ORIGIN``,
    direction (1, 0, 0)), in regen as in rebin and lanesort."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                           sampler=sampler, russian_roulette=1).with_sky(sky)
    o, d, idx = _rays(4, 64, 32)
    o, d = o.T.contiguous(), d.T.contiguous()
    n = o.shape[1]
    rebin, lane_sort = sampler == "rebin", sampler == "lanesort"
    home = (n if lane_sort else n // LANES) if rebin or lane_sort else None
    st = tint._regen_state(o, d, trng.per_ray_keys(trng.key(5), idx), home)
    route = tint._Route(WaveScene(scene), s, "pallas")
    park_d = torch.tensor([1.0, 0.0, 0.0])
    kept = parked = 0
    for it in range(s.rays_per_pixel * s.reflect_limit):
        before = _by_lane(st, sampler)
        tint._regen_iteration(route, st, it, rebin, lane_sort)
        after = _by_lane(st, sampler)
        was_done = before["sample_i"] >= s.rays_per_pixel
        now_done = after["sample_i"] >= s.rays_per_pixel
        for k in before:
            assert torch.equal(before[k][..., was_done],
                               after[k][..., was_done]), k
        new = now_done & ~was_done
        assert bool((after["o"][:, new] == tb.PARK_ORIGIN).all())
        assert bool((after["d"][:, new] == park_d[:, None]).all())
        kept += int(was_done.sum())
        parked += int(new.sum())
    assert kept > 0 and parked > 0


@pytest.mark.parametrize("route", ["eager", "graph"])
@pytest.mark.parametrize("sampler", ["regen", "rebin", "lanesort"])
def test_lane_iterations_count_the_loop(monkeypatch, eager_graphs, sampler,
                                        route):
    """The ``regen.lane_iterations`` count grows by N x the iterations the
    loop runs (eager, the plain route) or replays (the graph route, its
    capture stubbed as above), and the frame's segments are fewer: the
    share skipped, 1 - segments / lane-iterations, is above 0 on scene 4."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler).with_sky(sky)
    o, d, idx = _rays(4, 64, 32)
    ran = []
    iteration = tint._regen_iteration
    monkeypatch.setattr(tint, "_regen_iteration",
                        lambda *a: ran.append(1) or iteration(*a))
    before = trace.counts()["regen.lane_iterations"]
    _, segs = tint.render_sample_mean(
        WaveScene(scene), s, o, d, trng.frame_key(trng.key(1), 0),
        ray_idx=idx, backend="pallas" if route == "graph" else "plain")
    grown = trace.counts()["regen.lane_iterations"] - before
    assert len(ran) > 0 and grown == o.shape[0] * len(ran)
    assert 0 < float(segs) < grown
    assert bool(eager_graphs) == (route == "graph")


# -- finished lanes: the hit kernels' skip -----------------------------------

MASK_CASES = [("regen", False), ("rebin", False), ("lanesort", False),
              ("regen", True), ("scan", False), ("trace", False)]


@pytest.mark.parametrize("route", ["eager", "graph"])
@pytest.mark.parametrize("sampler,coherent", MASK_CASES)
def test_regen_hands_the_hit_kernels_its_mask(monkeypatch, eager_graphs,
                                              sampler, coherent, route):
    """Every hit of the regen loop (regen, rebin, lanesort, coherent regen)
    hands ``hit_raw`` the loop's mask, its lanes' ``sample_i`` ((N,)
    int32; on the graph route the static tensor itself, so the capture
    holds its pointer) and ``spp``; the scan sampler's and ``trace``'s
    hand it none. Scene 4, 64x32, 2 spp, 3 bounces, on the eager plain
    route and on the graph route (its capture stubbed as above)."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                           sampler="scan" if sampler == "trace" else sampler,
                           coherent=coherent).with_sky(sky)
    o, d, idx = _rays(4, 64, 32)
    calls = []
    hit_raw = tint.hit_raw

    def spy(ws, o_, d_, plain=False, **kw):
        calls.append(kw)
        return hit_raw(ws, o_, d_, plain, **kw)
    monkeypatch.setattr(tint, "hit_raw", spy)
    backend = "pallas" if route == "graph" else "plain"
    ws = WaveScene(scene)
    if sampler == "trace":
        rtt.trace(ws, s, o, d, trng.key(2), ray_idx=idx, backend=backend)
    else:
        tint.render_sample_mean(ws, s, o, d, trng.frame_key(trng.key(1), 0),
                                ray_idx=idx, backend=backend)
    assert calls and bool(eager_graphs) == (route == "graph")
    if sampler in ("scan", "trace"):
        assert all(kw == {} for kw in calls)
        return
    static = ws.graphs[("regen", o.shape[0], s, backend)].st["sample_i"] \
        if route == "graph" else None
    for kw in calls:
        assert sorted(kw) == ["sample_i", "spp"] and kw["spp"] == 2
        assert kw["sample_i"].dtype == torch.int32
        assert tuple(kw["sample_i"].shape) == (o.shape[0],)
        assert static is None or kw["sample_i"] is static


def _hit_scene(blocked: bool):
    """(scene, sky, the rays' ``_rays`` scene number) of a K5 test (scene
    4) or a K6 one: the level-4 SPD pyramid (1,024 triangles) forced onto
    the blocked layout, seen from the origin."""
    if blocked:
        from raytracer_tpu_torch.models import bench_scenes
        return (*bench_scenes.spd_tetra_scene(level=4, device="cpu"), 1)
    return (*_scene(4), 4)


class _FakeHitLib:
    """The kernel library's two hit entry points without a card: each call
    records the mask its arguments carry (sample pointer, spp) and
    reports a launch."""

    def __init__(self):
        self.masks = []

    def _launch(self, args, stream):
        self.masks.append((args._obj.sample, args._obj.spp))
        return 0

    rt_hit_resolve = rt_hit_resolve_blocked = _launch


@pytest.mark.parametrize("blocked", [False, True])
def test_skip_launches_grow_per_replay(monkeypatch, blocked):
    """The K5 / K6 wrappers put the regen mask into the kernel's arguments
    (``sample_i``'s pointer and spp; null and 0 without one) and count a
    launch that carried it under the kernel's ``.skip`` count. A capture
    of 8 masked launches and 2 without takes its counts back off the
    program counts, and each of 5 replays adds 8 to ``.skip`` and 10 to
    the kernel's launches (``torch.cuda.CUDAGraph`` and the library
    stubbed)."""
    from raytracer_tpu_torch.kernels import build

    class _Capturing:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    lib = _FakeHitLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: _EagerGraph(lambda: None))
    monkeypatch.setattr(torch.cuda, "graph", _Capturing)
    monkeypatch.setattr(twg, "warm_up", lambda ws, n: None)
    monkeypatch.setattr(trace, "_counts", collections.Counter())
    scene, _, num = _hit_scene(blocked)
    ws = WaveScene(scene, blocked=blocked)
    o, d, _ = _rays(num)
    o, d = o.T.contiguous(), tic.unit_rays(d.T.contiguous())[0]
    n = o.shape[1]
    sample_i = torch.zeros(n, dtype=torch.int32)

    def launch(**mask):
        if blocked:
            return tic._hit_resolve_blocked_cuda(ws.tables, o, d, 1, **mask)
        return tic._hit_resolve_cuda(ws.packed, o, d, group=1, **mask)

    def body():
        for _ in range(8):
            assert len(launch(sample_i=sample_i, spp=3)) == \
                (9 if blocked else 12)
        for _ in range(2):
            launch()
    g = twg.capture(ws, n, body)
    assert lib.masks == [(sample_i.data_ptr(), 3)] * 8 + [(None, 0)] * 2
    assert trace.counts() == collections.Counter({"graph.capture": 1})
    for _ in range(5):
        g.replay()
    c = trace.counts()
    kernel = "rt_hit_resolve_blocked" if blocked else "rt_hit_resolve"
    other = "rt_hit_resolve" if blocked else "rt_hit_resolve_blocked"
    assert c[kernel + ".skip"] == 40 and c[kernel] == 50 and c[other] == 0
    assert c["rt_hit_resolve.stats"] == 0


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("sampler,coherent", MASK_CASES[:4])
def test_plain_film_is_the_same_without_the_mask(monkeypatch, sampler,
                                                 coherent, blocked):
    """The plain route's frame (the pixel sums over spp, and the
    segments) is bitwise the same whether the regen loop hands the hit
    its mask or not: the plain K5 and K6 compute every row. 32x32 (8
    rows: rebin and lanesort regroup), 2 spp, 3 bounces, russian
    roulette; K5 on scene 4, K6 on the level-4 pyramid
    (``_hit_scene``)."""
    scene, sky, num = _hit_scene(blocked)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=1).with_sky(sky)
    o, d, idx = _rays(num, 32, 32)
    fkey = trng.frame_key(trng.key(3), 0)

    def frame():
        return tint.render_sample_mean(WaveScene(scene, blocked=blocked), s,
                                       o, d, fkey, ray_idx=idx,
                                       backend="plain")
    masked = frame()
    hit_raw = tint.hit_raw
    monkeypatch.setattr(tint, "hit_raw",
                        lambda ws, o_, d_, plain=False, **kw:
                        hit_raw(ws, o_, d_, plain))
    unmasked = frame()
    assert torch.equal(masked[0], unmasked[0])
    assert float(masked[1]) == float(unmasked[1]) > 0


@pytest.mark.parametrize("bad", ["no_spp", "no_sample", "int64", "short"])
def test_hit_raw_checks_the_mask(bad):
    """``hit_raw`` takes ``sample_i`` and ``spp`` together, ``sample_i``
    a contiguous (N,) int32 tensor on the rays' device, on every route."""
    scene, _ = _scene(4)
    ws = WaveScene(scene)
    o, d, _ = _rays(4)
    o, d = o.T.contiguous(), tic.unit_rays(d.T.contiguous())[0]
    n = o.shape[1]
    mask = {"no_spp": dict(sample_i=torch.zeros(n, dtype=torch.int32)),
            "no_sample": dict(spp=2),
            "int64": dict(sample_i=torch.zeros(n, dtype=torch.int64),
                          spp=2),
            "short": dict(sample_i=torch.zeros(n - 1, dtype=torch.int32),
                          spp=2)}[bad]
    with pytest.raises(ValueError, match="sample_i"):
        tic.hit_raw(ws, o, d, **mask)
    assert len(tic.hit_raw(ws, o, d, sample_i=torch.zeros(
        n, dtype=torch.int32), spp=2)) == 12
