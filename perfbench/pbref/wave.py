"""The wavefront regeneration sampler, one lane a pixel, vectorised over
any set of lanes.

Each lane traces its pixel's samples one after the other: every
iteration it draws from its pixel key folded with (sample, bounce), jitters
and renormalises its direction, finds the nearest hit along the unit
direction (triangles by exact division), shades and scatters; a path
that misses, or reaches the bounce limit, is banked into the pixel sum and
the lane restarts on its primary ray for the next sample. The draws
depend only on the lane's own (pixel, sample, bounce), so the schedule of
every lane is worked out here from its own history, for lanes of many
frames at once. The loop runs at most ``spp * limit`` iterations and
looks for its end every 8.
"""

from __future__ import annotations

import torch

from . import camera, rng
from .mega import INF, nearest, surface
from .scene import MAT_EMISSIVE, MAT_REFRACTIVE, TEX_CHECKER, \
    TEX_COLOUR, TEX_GRADIENT, TEX_IMAGE, Scene

AA_SCALE = 2.0 * 0.001
EXIT_CHECK_EVERY = 8


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a):
    return a * torch.rsqrt(_dot(a, a))[None, :]


def _trunc(x):
    lim = 2147483520.0
    x = torch.nan_to_num(x, nan=0.0, posinf=lim, neginf=-lim)
    return torch.clamp(x, -lim, lim).to(torch.int32)


def _texture(sc: Scene, row, u, v, hit):
    """(3, n) surface colour: constant, gradient, checker or image."""
    nsq, ttype = row[:, 16], row[:, 9]
    light = ((_trunc(u * nsq) + _trunc(v * nsq)) % 2) == 0
    checker = torch.where(light[None, :], row[:, 10:13].T, row[:, 13:16].T)
    gradient = torch.stack([u, v, torch.zeros_like(u)])
    out = torch.where((ttype == TEX_COLOUR)[None, :], row[:, 0:3].T, 0.0)
    out = torch.where((ttype == TEX_GRADIENT)[None, :], gradient, out)
    out = torch.where((ttype == TEX_CHECKER)[None, :], checker, out)
    if sc.image is not None:
        h, w = sc.image.shape[0], sc.image.shape[1]
        u_i = torch.clamp(_trunc((w - 1.0) * u), 0, w - 1).long()
        v_i = torch.clamp(_trunc((h - 1.0) * v), 0, h - 1).long()
        out = torch.where((ttype == TEX_IMAGE)[None, :],
                          sc.image[v_i, u_i].T, out)
    return out


def _scatter(gauss, fres, d, normal, row, cur_ior, has_refractive: bool):
    """The new direction and current index of refraction."""
    dt = d.dtype
    flip = torch.where(_dot(gauss, normal) < 0.0, -1.0, 1.0).to(dt)
    diffuse = _normalize(normal + _normalize(gauss * flip[None, :]))
    specular = _normalize(d - normal * (2.0 * _dot(d, normal))[None, :])
    smooth = row[:, 3]
    reflect = _normalize(diffuse + (specular - diffuse) * smooth[None, :])
    if not has_refractive:
        return reflect, cur_ior
    mat_ior = row[:, 5]
    exiting = _dot(normal, d) > 0.0
    n1 = torch.where(exiting, mat_ior, cur_ior)
    n2 = torch.where(exiting, cur_ior, mat_ior)
    ref_n = normal * torch.where(exiting, 1.0, -1.0).to(dt)[None, :]
    cos1 = torch.clamp(_dot(d, ref_n), max=1.0)
    sin1 = torch.sqrt(torch.clamp(1.0 - cos1 * cos1, min=0.0))
    sin2 = torch.clamp(n1 * sin1 / n2, max=1.0)
    cos2 = torch.sqrt(torch.clamp(1.0 - sin2 * sin2, min=0.0))
    tir = sin1 > (n2 / n1)
    sq = (n1 - n2) / (n1 + n2)
    r0 = sq * sq
    m = 1.0 - cos1
    m2 = m * m
    do_reflect = tir | ((r0 + (1.0 - r0) * (m2 * m2 * m)) > fres)
    safe = torch.where(sin1 == 0.0, 1.0, sin1)
    perp = torch.where((sin1 != 0.0)[None, :],
                       (d - ref_n * cos1[None, :]) / safe[None, :], 0.0)
    refr = _normalize(ref_n * cos2[None, :] + perp * sin2[None, :])
    is_refr = row[:, 4] == float(MAT_REFRACTIVE)
    new_d = torch.where(is_refr[None, :],
                        torch.where(do_reflect[None, :], reflect, refr),
                        reflect)
    return new_d, torch.where(is_refr, n2, cur_ior)


def lanes(sc: Scene, o0, d0, k0, k1, *, spp: int, limit: int,
          antialias: bool, sky):
    """Run lanes to the end: ``o0``, ``d0`` (3, n) primary rays (unit
    directions as the camera made them), ``k0``, ``k1`` (n,) int64 pixel
    keys. Returns the (3, n) mean radiance of each lane's pixel."""
    dev, dt = o0.device, o0.dtype
    n = o0.shape[1]
    o, d = o0.clone(), d0.clone()
    thru = torch.ones_like(o0)
    rad = torch.zeros_like(o0)
    pixel_sum = torch.zeros_like(o0)
    cur_ior = torch.ones(n, dtype=dt, device=dev)
    sample_i = torch.zeros(n, dtype=torch.int32, device=dev)
    bounce_i = torch.zeros(n, dtype=torch.int32, device=dev)
    sky_t = torch.tensor(sky, dtype=torch.float32, device=dev).to(dt)[:, None]
    cap = spp * limit
    it = 0
    while it < cap:
        if not bool((sample_i < spp).any()):
            break
        for _ in range(min(EXIT_CHECK_EVERY, cap - it)):
            draws = rng.lane_draws(k0, k1, sample_i, bounce_i, False, dt)
            dj = _normalize(d + (torch.stack(draws[0:3]) - 0.5) * AA_SCALE) \
                if antialias else d
            gauss, fres = torch.stack(draws[3:6]), draws[6]
            inv_len = torch.rsqrt(dj[0] * dj[0] + dj[1] * dj[1]
                                  + dj[2] * dj[2])
            unit = dj * inv_len[None, :]
            t, is_tri, prim, bu, bv = nearest(sc, o, unit, fast_div=False)
            (n0, n1, n2), u, v, row = surface(sc, is_tri, prim, bu, bv)
            t = torch.where(t < INF, t * inv_len, INF)
            hit = t < INF
            safe_t = torch.where(hit, t, 0.0)
            point = o + dj * safe_t[None, :]
            rx, ry, rz = point[0] - n0, point[1] - n1, point[2] - n2
            rmag = torch.rsqrt(torch.clamp(rx * rx + ry * ry + rz * rz,
                                           min=1e-24))
            sph_n = (rx * rmag, ry * rmag, rz * rmag)
            if sc.need_sphere_uv:
                theta = torch.asin(torch.clamp(sph_n[1], -1.0, 1.0))
                phi = torch.acos(torch.clamp(sph_n[0], -1.0, 1.0))
                sph_u = (theta + torch.pi / 2.0) / torch.pi
                v_ratio = (1.0 - phi / torch.pi) / 2.0
                behind = (point[2] > n2).to(dt)
                sph_v = behind + (1.0 - 2.0 * behind) * v_ratio
            else:
                sph_u = sph_v = torch.zeros_like(u)
            flip = 1.0 - 2.0 * (n0 * dj[0] + n1 * dj[1] + n2 * dj[2]
                                > 0.0).to(dt)
            normal = torch.stack([torch.where(is_tri, n0 * flip, sph_n[0]),
                                  torch.where(is_tri, n1 * flip, sph_n[1]),
                                  torch.where(is_tri, n2 * flip, sph_n[2])])
            uu = torch.where(is_tri, u, sph_u)
            vv = torch.where(is_tri, v, sph_v)

            alive = sample_i < spp
            miss = alive & ~hit
            rad = rad + torch.where(miss[None, :], thru * sky_t, 0.0)
            is_em = row[:, 4] == float(MAT_EMISSIVE)
            live_hit = alive & hit
            rad = rad + torch.where((live_hit & is_em)[None, :],
                                    thru * row[:, 6:9].T, 0.0)
            tex = _texture(sc, row, uu, vv, hit)
            thru = torch.where((live_hit & ~is_em)[None, :], thru * tex,
                               thru)
            new_d, new_ior = _scatter(gauss, fres, dj, normal, row, cur_ior,
                                      sc.has_refractive)
            o = torch.where(live_hit[None, :], point, o)
            d = torch.where(live_hit[None, :], new_d, dj)
            cur_ior = torch.where(live_hit, new_ior, cur_ior)
            path_end = alive & (~live_hit | (bounce_i + 1 >= limit))
            pixel_sum = pixel_sum + torch.where(path_end[None, :], rad, 0.0)
            sample_i = torch.where(path_end, sample_i + 1, sample_i)
            bounce_i = torch.where(path_end, 0,
                                   torch.where(alive, bounce_i + 1,
                                               bounce_i))
            restart = path_end[None, :]
            o = torch.where(restart, o0, o)
            d = torch.where(restart, d0, d)
            thru = torch.where(restart, 1.0, thru)
            rad = torch.where(restart, 0.0, rad)
            cur_ior = torch.where(path_end, 1.0, cur_ior)
        it += min(EXIT_CHECK_EVERY, cap - it)
    return pixel_sum / torch.full((), float(spp), dtype=dt, device=dev)


def progressive(sc: Scene, pose: dict, width: int, height: int, spp: int,
                limit: int, antialias: bool, sky, seed: int, frames: int,
                positions: torch.Tensor, dtype=torch.float32):
    """The regen sampler's progressive film after ``frames`` frames at
    ray-array ``positions`` (Morton order): (P, 3)."""
    dev = positions.device
    pix = torch.as_tensor(camera.morton_order(width, height),
                          device=dev)[positions]
    o_r, d_r = camera.rays(pose, width, height, pix, dtype)
    base = rng.key(seed)
    k0s, k1s = [], []
    for f in range(frames):
        fk = rng.fold_in(base, f)
        a, b = rng.threefry2x32(fk[0], fk[1], 0, pix & rng.MASK)
        k0s.append(a)
        k1s.append(b)
    mean = lanes(sc, o_r.T.repeat(1, frames), d_r.T.repeat(1, frames),
                 torch.cat(k0s), torch.cat(k1s), spp=spp, limit=limit,
                 antialias=antialias, sky=sky)
    p = positions.shape[0]
    mean = mean.reshape(3, frames, p)
    film = torch.zeros((p, 3), dtype=dtype, device=dev)
    for f in range(frames):
        fn = float(f)
        film = film.mul(fn).add(mean[:, f].T).div(fn + 1.0)
    return film
