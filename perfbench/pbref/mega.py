"""The megakernel sampler, one lane slot at a time, vectorised over any
set of lanes.

A lane slot owns ``pixpack`` (K) pixels and runs paths with
regeneration: a finished path is banked into its pixel and the lane
restarts on its next sample, and after ``spp`` samples on its next pixel,
until its ``spp * K`` budget is spent. Every random bit of a lane is the
counter hash of (its frame's seed words, its global tile, the loop
iteration, element ``row * 4096 + slot``): rows 0-2 give the diffuse
direction and the Fresnel uniform, their top bytes the antialias jitter.
A lane depends on nothing but its own rays and seed words, so lanes of
many frames and any subset of a frame's lanes run together here.

Nearest hit: every primitive is tested; the winner is the first in the
order (t, is_triangle, index). Spheres take the half-b quadratic on unit
directions, triangles the Woop rows with the FAST_DIV reciprocal (the
float32 reciprocal of the bfloat16-rounded divisor, one Newton step).
"""

from __future__ import annotations

import math

import torch

from . import rng
from .scene import (MAT_EMISSIVE, MAT_REFRACTIVE, TEX_CHECKER, TEX_GRADIENT,
                    TEX_IMAGE, Scene)

EPS = 1e-6
INF = 1e30
TILE = 4096                 # lane slots a tile
AA_RANGE = 0.001            # antialias jitter half-range (src/ray.cu:4)
_CHUNK = 1 << 24            # (rays x primitives) elements a hit chunk


def _fast_recip(x: torch.Tensor) -> torch.Tensor:
    r0 = 1.0 / x.to(torch.bfloat16).to(x.dtype)
    return r0 * (2.0 - x * r0)


def _asin(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 4.4.45 arcsin."""
    ax = torch.abs(x)
    r = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * -0.0187293))
    v = math.pi / 2.0 - torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * r
    return torch.where(x < 0.0, -v, v)


def nearest(sc: Scene, o, d, fast_div: bool = True):
    """Nearest hit of rays ``o``, ``d`` (3, n): (t, is_tri, prim, u, v),
    t = INF on a miss; u, v are the triangle's barycentrics."""
    n = o.shape[1]
    m = max(sc.sph.shape[0], sc.tri_w.shape[0], 1)
    chunk = max(1, _CHUNK // m)
    parts = []
    for lo in range(0, n, chunk):
        ox, oy, oz, dx, dy, dz = (x[lo:lo + chunk, None] for x in (*o, *d))
        c = sc.sph
        ddo = dx * ox + dy * oy + dz * oz
        osq = ox * ox + oy * oy + oz * oz
        cx, cy, cz, r = (c[:, k][None] for k in range(4))
        cr2 = torch.where(r > 0.0, (cx * cx + cy * cy + cz * cz) - r * r,
                          INF)
        dc = dx * cx + dy * cy + dz * cz
        oc = ox * cx + oy * cy + oz * cz
        h = dc - ddo
        cq = (cr2 + osq) - (oc + oc)
        t = h - torch.sqrt(h * h - cq)
        t = torch.where(t > EPS, t, INF)
        if t.shape[1] == 0:
            t = torch.full((t.shape[0], 1), INF, dtype=o.dtype,
                           device=o.device)
        s_idx = torch.argmin(t, dim=1)
        s_t = torch.gather(t, 1, s_idx[:, None])[:, 0]

        w = [sc.tri_w[:, k][None] for k in range(12)]
        ow = w[8] * ox + w[9] * oy + w[10] * oz + w[11]
        dw = w[8] * dx + w[9] * dy + w[10] * dz
        tt = -ow * _fast_recip(dw) if fast_div else -ow / dw
        u = (w[0] * ox + w[1] * oy + w[2] * oz + w[3]) + tt * (
            w[0] * dx + w[1] * dy + w[2] * dz)
        v = (w[4] * ox + w[5] * oy + w[6] * oz + w[7]) + tt * (
            w[4] * dx + w[5] * dy + w[6] * dz)
        ok = (tt > EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        if sc.has_one_way:
            cl = sc.tri_cull
            ok &= (cl[:, 0][None] * dx + cl[:, 1][None] * dy
                   + cl[:, 2][None] * dz) >= 0.0
        tt = torch.where(ok, tt, INF)
        if tt.shape[1] == 0:
            tt = torch.full((tt.shape[0], 1), INF, dtype=o.dtype,
                            device=o.device)
            u = v = torch.zeros_like(tt)
        t_idx = torch.argmin(tt, dim=1)
        t_t = torch.gather(tt, 1, t_idx[:, None])[:, 0]
        bu = torch.gather(u, 1, t_idx[:, None])[:, 0]
        bv = torch.gather(v, 1, t_idx[:, None])[:, 0]
        is_tri = t_t < s_t
        bt = torch.where(is_tri, t_t, s_t)
        prim = torch.where(is_tri, t_idx, torch.where(s_t < INF, s_idx, 0))
        parts.append((bt, is_tri, prim, torch.where(is_tri, bu, 0.0),
                      torch.where(is_tri, bv, 0.0)))
    return tuple(torch.cat(p) for p in zip(*parts))


def surface(sc: Scene, is_tri, prim, bu, bv):
    """The winner's normal (sphere centre or triangle normal), texture
    uv and its primitive row (``Scene.prim``)."""
    s_prim = torch.where(is_tri, 0, prim)
    t_prim = torch.where(is_tri, prim, 0)
    ns = sc.tri_w.shape[0]
    sph = sc.sph[s_prim.clamp(max=max(sc.n_sph - 1, 0))] if sc.n_sph else \
        torch.zeros((prim.shape[0], 4), dtype=bu.dtype, device=bu.device)
    tri_n = sc.tri_n[t_prim.clamp(max=max(ns - 1, 0))] if ns else \
        torch.zeros((prim.shape[0], 3), dtype=bu.dtype, device=bu.device)
    nrm = [torch.where(is_tri, tri_n[:, c], sph[:, c]) for c in range(3)]
    row = sc.prim[torch.where(is_tri, sc.n_sph + t_prim, s_prim)]
    if sc.needs_tri_uv and ns:
        uv = sc.tri_uv[t_prim]
        wb = 1.0 - bu - bv
        tu = uv[:, 0] * wb + uv[:, 2] * bu + uv[:, 4] * bv
        tv = uv[:, 1] * wb + uv[:, 3] * bu + uv[:, 5] * bv
        u = torch.where(is_tri, tu, 0.0)
        v = torch.where(is_tri, tv, 0.0)
    else:
        u = torch.zeros_like(bu)
        v = torch.zeros_like(bv)
    return nrm, u, v, row


def _trunc(x: torch.Tensor) -> torch.Tensor:
    lim = 2147483520.0
    x = torch.nan_to_num(x, nan=0.0, posinf=lim, neginf=-lim)
    return torch.clamp(x, -lim, lim).to(torch.int32)


def texel(img: torch.Tensor, uu, vv):
    """The nearest texel of (u, v): columns (w - 1) * u and rows
    (h - 1) * v, truncated and clamped into the image."""
    h, w = img.shape[0], img.shape[1]
    u_i = torch.clamp(_trunc((w - 1.0) * uu), 0, w - 1).long()
    v_i = torch.clamp(_trunc((h - 1.0) * vv), 0, h - 1).long()
    t = img[v_i, u_i]
    return t[:, 0], t[:, 1], t[:, 2]


def shade_colour(sc: Scene, row, uu, vv, pcol, hit):
    """The surface colour: checker, gradient, image texel or the
    primitive's constant colour."""
    nsq = row[:, 16]
    light = ((uu * nsq).to(torch.int32) + (vv * nsq).to(torch.int32)) \
        % 2 == 0
    is_chk = row[:, 9] == float(TEX_CHECKER)
    is_grad = row[:, 9] == float(TEX_GRADIENT)
    out = []
    for c, base in enumerate(pcol):
        grad = (uu, vv, torch.zeros_like(uu))[c]
        out.append(torch.where(is_chk, torch.where(light, row[:, 10 + c],
                                                   row[:, 13 + c]),
                               torch.where(is_grad, grad, base)))
    if sc.image is not None:
        is_img = (row[:, 9] == float(TEX_IMAGE)) & hit
        img = texel(sc.image, uu, vv)
        out = [torch.where(is_img, i, x) for i, x in zip(img, out)]
    return out


def lanes(sc: Scene, o0, d0, w0, w1, slot, *, spp: int, limit: int,
          antialias: bool, sky):
    """Run lane slots to the end of their budget.

    ``o0``, ``d0``: (3, K, L) unit primary rays of each lane's K pixels;
    ``w0``, ``w1``: (L,) int64 seed words, w1 with the lane's global tile
    folded in (``rng.tile_w1``); ``slot``: (L,) the lane's slot in its
    tile. Returns the (3, K, L) mean radiance of each pixel and its (K, L)
    primary-hit depth."""
    dev, dt = o0.device, o0.dtype
    k_pp, n = o0.shape[1], o0.shape[2]
    elems = [i * TILE + slot for i in range(3)]
    budget = spp * k_pp
    ox, oy, oz = (x.clone() for x in o0[:, 0])
    dx, dy, dz = (x.clone() for x in d0[:, 0])
    ones = torch.ones(n, dtype=dt, device=dev)
    tr, tg, tb = ones.clone(), ones.clone(), ones.clone()
    rr, rg, rb = (torch.zeros(n, dtype=dt, device=dev) for _ in range(3))
    ior = ones.clone()
    bounce = torch.zeros(n, dtype=torch.int64, device=dev)
    sample = torch.zeros_like(bounce)
    cur_k = torch.zeros_like(bounce)
    sums = torch.zeros((3, k_pp, n), dtype=dt, device=dev)
    depth = torch.full((k_pp, n), INF, dtype=dt, device=dev)
    itc = 0
    while True:
        itc += 1
        active = sample < budget
        if itc % 8 == 1 and not bool(active.any()):
            break
        bits = [rng.hash_bits(w0, w1, itc, e) for e in elems]

        def uni(i):
            return (bits[i] & 0x00FFFFFF).to(dt) * (1.0 / 16777216.0)

        if antialias:
            jit = [((bits[i] >> 24) & 0xFF).to(dt) * (1.0 / 256.0)
                   + (0.5 / 256.0) for i in range(3)]
            dx = dx + (jit[0] - 0.5) * (2 * AA_RANGE)
            dy = dy + (jit[1] - 0.5) * (2 * AA_RANGE)
            dz = dz + (jit[2] - 0.5) * (2 * AA_RANGE)
            inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
            dx, dy, dz = dx * inv, dy * inv, dz * inv
        z = 2.0 * uni(0) - 1.0
        phi = (2.0 * math.pi) * uni(1)
        rs = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        gx, gy, gz = rs * torch.cos(phi), rs * torch.sin(phi), z
        fres_u = uni(2)

        bt, is_tri, prim, bu, bv = nearest(
            sc, torch.stack([ox, oy, oz]), torch.stack([dx, dy, dz]))
        (n0, n1, n2), uu_t, vv_t, row = surface(sc, is_tri, prim, bu, bv)
        hit = bt < INF
        first = active & (bounce == 0) & (sample == cur_k * spp)
        cur_depth = depth.gather(0, cur_k[None])[0]
        depth.scatter_(0, cur_k[None], torch.where(first, bt,
                                                   cur_depth)[None])
        safe_t = torch.where(hit, bt, 0.0)
        px, py, pz = ox + dx * safe_t, oy + dy * safe_t, oz + dz * safe_t
        rx, ry, rz = px - n0, py - n1, pz - n2
        rmag = torch.rsqrt(torch.clamp(rx * rx + ry * ry + rz * rz,
                                       min=1e-24))
        if sc.need_sphere_uv:
            theta = _asin(torch.clamp(ry * rmag, -1.0, 1.0))
            phi_s = math.pi / 2.0 - _asin(torch.clamp(rx * rmag, -1.0, 1.0))
            sph_u = (theta + math.pi / 2.0) / math.pi
            v_ratio = (1.0 - phi_s / math.pi) / 2.0
            behind = torch.where(pz > n2, 1.0, 0.0).to(dt)
            sph_v = behind + (1.0 - 2.0 * behind) * v_ratio
        else:
            sph_u = sph_v = torch.zeros_like(px)
        ndd = n0 * dx + n1 * dy + n2 * dz
        flip = torch.where(ndd > 0.0, -1.0, 1.0).to(dt)
        nx = torch.where(is_tri, n0 * flip, rx * rmag)
        ny = torch.where(is_tri, n1 * flip, ry * rmag)
        nz = torch.where(is_tri, n2 * flip, rz * rmag)
        uu = torch.where(is_tri, uu_t, sph_u)
        vv = torch.where(is_tri, vv_t, sph_v)
        msm, mtype, mior = row[:, 3], row[:, 4], row[:, 5]
        tex_r, tex_g, tex_b = shade_colour(
            sc, row, uu, vv, (row[:, 0], row[:, 1], row[:, 2]), hit)

        miss = active & ~hit
        rr = rr + torch.where(miss, tr * sky[0], 0.0)
        rg = rg + torch.where(miss, tg * sky[1], 0.0)
        rb = rb + torch.where(miss, tb * sky[2], 0.0)
        is_em = mtype == float(MAT_EMISSIVE)
        live_hit = active & hit
        em = live_hit & is_em
        rr = rr + torch.where(em, tr * row[:, 6], 0.0)
        rg = rg + torch.where(em, tg * row[:, 7], 0.0)
        rb = rb + torch.where(em, tb * row[:, 8], 0.0)
        absorb = live_hit & ~is_em
        tr = torch.where(absorb, tr * tex_r, tr)
        tg = torch.where(absorb, tg * tex_g, tg)
        tb = torch.where(absorb, tb * tex_b, tb)

        gdotn = gx * nx + gy * ny + gz * nz
        gflip = torch.where(gdotn < 0.0, -1.0, 1.0).to(dt)
        dinv = torch.rsqrt(2.0 + 2.0 * torch.abs(gdotn))
        dfx = (nx + gx * gflip) * dinv
        dfy = (ny + gy * gflip) * dinv
        dfz = (nz + gz * gflip) * dinv
        ddn = dx * nx + dy * ny + dz * nz
        sx, sy, sz = dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, \
            dz - 2.0 * ddn * nz
        refx = dfx + (sx - dfx) * msm
        refy = dfy + (sy - dfy) * msm
        refz = dfz + (sz - dfz) * msm
        rinv = torch.rsqrt(torch.clamp(
            refx * refx + refy * refy + refz * refz, min=1e-24))
        refx, refy, refz = refx * rinv, refy * rinv, refz * rinv
        if sc.has_refractive:
            exiting = ddn > 0.0
            n1_ = torch.where(exiting, mior, ior)
            n2_ = torch.where(exiting, ior, mior)
            sgn = torch.where(exiting, 1.0, -1.0).to(dt)
            rnx, rny, rnz = nx * sgn, ny * sgn, nz * sgn
            cos1 = torch.clamp(dx * rnx + dy * rny + dz * rnz, max=1.0)
            sin1 = torch.sqrt(torch.clamp(1.0 - cos1 * cos1, min=0.0))
            sin2 = torch.clamp(n1_ * sin1 / n2_, max=1.0)
            cos2 = torch.sqrt(torch.clamp(1.0 - sin2 * sin2, min=0.0))
            tir = sin1 * n1_ > n2_
            sq0 = (n1_ - n2_) / (n1_ + n2_)
            r0 = sq0 * sq0
            mm_ = 1.0 - cos1
            m2 = mm_ * mm_
            refl = r0 + (1.0 - r0) * (m2 * m2 * mm_)
            do_reflect = tir | (refl > fres_u)
            inv_s1 = torch.where(sin1 == 0.0, 0.0,
                                 1.0 / torch.where(sin1 == 0.0, 1.0, sin1))
            pfx = (dx - rnx * cos1) * inv_s1
            pfy = (dy - rny * cos1) * inv_s1
            pfz = (dz - rnz * cos1) * inv_s1
            is_refr = mtype == float(MAT_REFRACTIVE)
            use_refr = is_refr & ~do_reflect
            ndx = torch.where(use_refr, rnx * cos2 + pfx * sin2, refx)
            ndy = torch.where(use_refr, rny * cos2 + pfy * sin2, refy)
            ndz = torch.where(use_refr, rnz * cos2 + pfz * sin2, refz)
            new_ior = torch.where(is_refr & live_hit, n2_, ior)
        else:
            ndx, ndy, ndz, new_ior = refx, refy, refz, ior
        ox = torch.where(live_hit, px, ox)
        oy = torch.where(live_hit, py, oy)
        oz = torch.where(live_hit, pz, oz)
        dx = torch.where(live_hit, ndx, dx)
        dy = torch.where(live_hit, ndy, dy)
        dz = torch.where(live_hit, ndz, dz)
        ior = new_ior

        path_end = active & (~live_hit | (bounce + 1 >= limit))
        banked = torch.stack([torch.where(path_end, rr, 0.0),
                              torch.where(path_end, rg, 0.0),
                              torch.where(path_end, rb, 0.0)])
        sums.scatter_add_(1, cur_k[None, None, :].expand(3, 1, n),
                          banked[:, None, :])
        sample = torch.where(path_end, sample + 1, sample)
        bounce = torch.where(path_end, 0,
                             torch.where(active, bounce + 1, bounce))
        adv = path_end & (sample == (cur_k + 1) * spp)
        cur_k = torch.clamp(cur_k + adv.to(torch.int64), max=k_pp - 1)
        sel = cur_k[None, None, :].expand(3, 1, n)
        o_s = o0.gather(1, sel)[:, 0]
        d_s = d0.gather(1, sel)[:, 0]
        ox = torch.where(path_end, o_s[0], ox)
        oy = torch.where(path_end, o_s[1], oy)
        oz = torch.where(path_end, o_s[2], oz)
        dx = torch.where(path_end, d_s[0], dx)
        dy = torch.where(path_end, d_s[1], dy)
        dz = torch.where(path_end, d_s[2], dz)
        tr = torch.where(path_end, 1.0, tr)
        tg = torch.where(path_end, 1.0, tg)
        tb = torch.where(path_end, 1.0, tb)
        rr = torch.where(path_end, 0.0, rr)
        rg = torch.where(path_end, 0.0, rg)
        rb = torch.where(path_end, 0.0, rb)
        ior = torch.where(path_end, 1.0, ior)
    inv_spp = float(torch.tensor(1.0 / float(spp), dtype=torch.float32))
    return sums * inv_spp, depth
