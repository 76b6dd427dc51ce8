"""Full-frame megakernel sampler: spp x bounces x shading in one kernel.

Port of ``raytracer_tpu/ops/megakernel.py``. ``render_sample_mean_mega``
pads and normalises the primary rays, packs the scene, derives the seed
words and then either launches ``rt_megakernel`` (csrc/megakernel.cu) for
CUDA tensors or runs ``mega_reference`` for CPU tensors. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

Image textures (K4, ``_fetch_image`` in the JAX kernel): ``pack_textures``
packs every image into one (img_rows, 128) int32 plane of colour30 texels,
and the kernel reads one texel per image hit with one global load
(``fetch_image_reference`` is its plain version, ``fetch_image`` runs it
alone). The TPU keeps that plane in three residency tiers (static VMEM
select, clamped select, HBM pages; megakernel.py:136-163); on the card
they are one load from global memory, and every supported scene,
whatever its image size, renders through this kernel.

Layout (the JAX kernel's, with one 32-row stream): a tile is 4096 lane
slots times ``pixpack`` (K) pixels. Lane slot (tile, r, l) owns pixels
``tile*4096*K + (k*32 + r)*128 + l`` for k < K. Each lane runs paths with
regeneration: a finished path is banked into its pixel and the lane
restarts on its next sample (and, once a pixel has its spp samples, on its
next pixel) until its ``spp * K`` budget is spent.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..config import ANTIALIAS_OFFSET_RANGE, RenderSettings
from ..models.materials import (MAT_EMISSIVE, MAT_REFRACTIVE,
                                TEX_CHECKERBOARD, TEX_GRADIENT, TEX_IMAGE)
from . import rng, sweep

LANES = sweep.LANES
SROWS = 32                 # rows per pixel block (one stream)
MEGA_TILE = SROWS * LANES  # lane slots per tile
INF = sweep.INF

# material table rows (megakernel.py:130-132)
(_M_TYPE, _M_IOR, _M_EMR, _M_EMG, _M_EMB, _M_TEXTYPE,
 _M_LR, _M_LG, _M_LB, _M_DR, _M_DG, _M_DB, _M_NSQ,
 _M_TW, _M_TH, _M_TROW) = range(16)

# Launches of rt_megakernel by ``render_sample_mean_mega``; of those, the
# launches whose scene has a texel plane, so that the kernel's image fetch
# (K4) runs inside them; launches of rt_fetch_image by ``fetch_image``.
LAUNCHES = 0
IMAGE_LAUNCHES = 0
FETCH_LAUNCHES = 0


def supports(scene) -> bool:
    """Scenes the port's megakernel renders: all of them, as long as the
    texel plane can be indexed with int32 (img_rows * 128 < 2^31)."""
    return scene.img_rows * LANES < 2 ** 31


def mega_tile_for(scene) -> int:
    """Lane slots per megakernel tile (times pixpack = pixels per tile)."""
    return MEGA_TILE


def pack_materials(scene) -> torch.Tensor:
    """(16, M) float32 material rows (megakernel.py:245)."""
    f32 = torch.float32
    return torch.cat([
        scene.mat_type.to(f32)[None, :],
        scene.mat_ior[None, :],
        scene.mat_emit.T,
        scene.tex_type.to(f32)[None, :],
        scene.tex_light.T,
        scene.tex_dark.T,
        scene.tex_nsq[None, :],
        scene.tex_width.to(f32)[None, :],
        scene.tex_height.to(f32)[None, :],
        scene.tex_row.to(f32)[None, :],
    ], dim=0).contiguous()


def pack_textures(scene) -> torch.Tensor:
    """Image textures -> the (img_rows, 128) int32 colour30 texel plane
    (megakernel.py:209-232), on the scene's device.

    Row ``trow + v * nb + (u >> 7)``, lane ``u & 127`` holds texel (v, u)
    of the image whose rows start at ``trow``, where ``nb = ceil(w / 128)``
    is the image's column-block count. A scene without images gets one
    zero row.
    """
    dev = scene.atlas.device
    if scene.img_rows == 0:
        return torch.zeros((1, LANES), dtype=torch.int32, device=dev)
    planes = torch.zeros((scene.img_rows, LANES), dtype=torch.int32,
                         device=dev)
    for (off, h, w, row) in scene.img_layout:
        img = scene.atlas[off:off + h * w].reshape(h, w, 3)
        packed = sweep.encode_colour30(img)                   # (h, w)
        nb = -(-w // LANES)
        packed = torch.nn.functional.pad(packed, (0, nb * LANES - w))
        planes[row:row + h * nb] = packed.reshape(h * nb, LANES)
    return planes


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 toward zero, saturating, NaN -> 0: XLA's convert
    (which the JAX kernel's ``astype`` runs) and CUDA's __float2int_rz.
    A bare ``.to(int32)`` is undefined past the int32 range on the CPU."""
    lim = 2147483520.0                        # largest float32 < 2^31
    x = torch.nan_to_num(x, nan=0.0, posinf=lim, neginf=-lim)
    return torch.clamp(x, -lim, lim).to(torch.int32)


def fetch_image_reference(tex: torch.Tensor, img_rows: int, uu, vv, mtw,
                          mth, mtrow):
    """Plain K4: the nearest texel of (u, v) (megakernel.py:282-292,
    src/material.cu:119-124) from the texel plane; ``mtw``, ``mth``,
    ``mtrow`` are the material's width, height and first row as float32.
    Returns (r, g, b) float32."""
    w_i = _trunc_int(mtw)
    u_i = torch.clamp(_trunc_int((mtw - 1.0) * uu), min=0)
    u_i = torch.minimum(u_i, torch.clamp(w_i - 1, min=0))
    v_i = torch.clamp(_trunc_int((mth - 1.0) * vv), min=0)
    v_i = torch.minimum(v_i, torch.clamp(_trunc_int(mth) - 1, min=0))
    nb = (w_i + (LANES - 1)) >> 7            # column blocks per image row
    ty = _trunc_int(mtrow) + v_i * nb + (u_i >> 7)
    ty = torch.clamp(ty, 0, img_rows - 1)
    texel = tex.reshape(-1)[ty.long() * LANES + (u_i & (LANES - 1)).long()]
    return sweep.decode_colour30(texel)


def resolve_pixpack(settings: RenderSettings, pixpack=None) -> int:
    """Explicit argument > settings.pixpack > 1."""
    if pixpack is not None:
        k = int(pixpack)
    elif settings.pixpack is not None:
        k = int(settings.pixpack)
    else:
        k = 1
    if k < 1:
        raise ValueError(f"pixpack must be >= 1, got {k}")
    return k


def pad_rays(o: torch.Tensor, d: torch.Tensor, k: int):
    """Pad (3, N) rays to whole tiles of 4096*k pixels with o = 0,
    d = (1, 0, 0), and normalise d with rsqrt (megakernel.py:1189-1202)."""
    n = o.shape[1]
    tile = MEGA_TILE * k
    n_pad = max(tile, -(-n // tile) * tile)
    if n_pad != n:
        pad_o = torch.zeros((3, n_pad - n), dtype=o.dtype, device=o.device)
        pad_d = torch.zeros((3, n_pad - n), dtype=d.dtype, device=d.device)
        pad_d[0] = 1.0
        o = torch.cat([o, pad_o], dim=1)
        d = torch.cat([d, pad_d], dim=1)
    inv = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return o.contiguous(), (d * inv[None, :]).contiguous()


def _asin(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 4.4.45 arcsin (megakernel.py:359-367)."""
    ax = torch.abs(x)
    r = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * -0.0187293))
    v = math.pi / 2.0 - torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * r
    return torch.where(x < 0.0, -v, v)


def mega_reference(ps: sweep.PackedScene, mat: torch.Tensor,
                   o: torch.Tensor, d: torch.Tensor, seed, *,
                   tex: torch.Tensor, img_rows: int,
                   pixpack: int, spp: int, limit: int, antialias: bool,
                   sky, emissive_terminates: bool, fix_exit_ior: bool,
                   need_sphere_uv: bool, has_refractive: bool,
                   rr_start: int) -> torch.Tensor:
    """Plain version of ``rt_megakernel``: a vectorised emulation of the
    JAX kernel's per-lane loop (megakernel.py:479-1081) with the
    interpret-mode hash RNG.

    ``o``, ``d``: (3, n_pad) padded primary rays, unit d. ``seed``:
    (w0, w1, tile_offset) from ``rng.seed_words``. ``tex``: the texel
    plane (``pack_textures``), read when ``img_rows`` > 0. Returns (5, n_pad):
    mean r, g, b, segments (lane totals on pixel block 0) and primary
    depth. All lanes advance together, one loop iteration per step, and
    every update is gated on the lane still being active, as in the JAX
    tile loop.
    """
    dev = o.device
    f32 = torch.float32
    k_pp = pixpack
    n_pad = o.shape[1]
    n_lanes = n_pad // k_pp
    lane = torch.arange(n_lanes, device=dev, dtype=torch.int64)
    tile = lane // MEGA_TILE
    rl = lane % MEGA_TILE
    # pixel of lane g, block k: tile*4096*K + k*4096 + rl
    pix = (tile * MEGA_TILE * k_pp + rl)[None, :] + (
        torch.arange(k_pp, device=dev, dtype=torch.int64)[:, None]
        * MEGA_TILE)                                         # (K, L)
    o0 = o[:, pix]                                           # (3, K, L)
    d0 = d[:, pix]
    w0, w1_frame, tile_offset = seed
    w1 = rng.tile_w1(w1_frame, tile + tile_offset)
    nrand = 3 + (1 if rr_start > 0 else 0)
    elems = [i * MEGA_TILE + rl for i in range(nrand)]
    budget = spp * k_pp
    jit_scale = 2 * ANTIALIAS_OFFSET_RANGE

    ox, oy, oz = (x.clone() for x in o0[:, 0])
    dx, dy, dz = (x.clone() for x in d0[:, 0])
    zeros = torch.zeros(n_lanes, dtype=f32, device=dev)
    ones = torch.ones(n_lanes, dtype=f32, device=dev)
    tr, tg, tb = ones.clone(), ones.clone(), ones.clone()
    rr, rg, rb = zeros.clone(), zeros.clone(), zeros.clone()
    ior = ones.clone()
    bounce = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    sample = torch.zeros_like(bounce)
    cur_k = torch.zeros_like(bounce)
    segs = zeros.clone()
    sums = torch.zeros((3, k_pp, n_lanes), dtype=f32, device=dev)
    depth = torch.full((k_pp, n_lanes), INF, dtype=f32, device=dev)

    itc = 0
    while True:
        itc += 1
        active = sample < budget
        # look for the end only every 8 iterations (each look is a host
        # sync on the card); the extra iterations change nothing, since
        # every update is gated on ``active``
        if itc % 8 == 1 and not bool(active.any()):
            break
        segs = segs + active.to(f32)
        bits = [rng.hash_bits(w0, w1, itc, e) for e in elems]

        def uni(i):
            return (bits[i] & 0x00FFFFFF).to(f32) * (1.0 / 16777216.0)

        if antialias:
            def jit_u(i):
                return ((bits[i] >> 24) & 0xFF).to(f32) * (1.0 / 256.0) + (
                    0.5 / 256.0)
            dx = dx + (jit_u(0) - 0.5) * jit_scale
            dy = dy + (jit_u(1) - 0.5) * jit_scale
            dz = dz + (jit_u(2) - 0.5) * jit_scale
            inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
            dx, dy, dz = dx * inv, dy * inv, dz * inv

        z = 2.0 * uni(0) - 1.0
        phi = (2.0 * math.pi) * uni(1)
        rs = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        gx, gy, gz = rs * torch.cos(phi), rs * torch.sin(phi), z
        fres_u = uni(2)

        bt, bc, uu_t, vv_t, n0, n1, n2, pa, pb = sweep.nearest_hit_reference(
            ps, torch.stack([ox, oy, oz]), torch.stack([dx, dy, dz]))
        msm, mid = sweep.decode_smooth_mat(pb)
        pcol_r, pcol_g, pcol_b = sweep.decode_colour30(pa)
        hit = bt < INF
        is_tri = (bc & 1) == 1

        first = active & (bounce == 0) & (sample == cur_k * spp)
        cur_depth = depth.gather(0, cur_k[None])[0]
        depth.scatter_(0, cur_k[None],
                       torch.where(first, bt, cur_depth)[None])
        safe_t = torch.where(hit, bt, 0.0)
        px = ox + dx * safe_t
        py = oy + dy * safe_t
        pz = oz + dz * safe_t

        rx, ry, rz = px - n0, py - n1, pz - n2
        rmag = torch.rsqrt(torch.clamp(rx * rx + ry * ry + rz * rz,
                                       min=1e-24))
        if need_sphere_uv:
            theta = _asin(torch.clamp(ry * rmag, -1.0, 1.0))
            phi_s = math.pi / 2.0 - _asin(torch.clamp(rx * rmag, -1.0, 1.0))
            sph_u = (theta + math.pi / 2.0) / math.pi
            v_ratio = (1.0 - phi_s / math.pi) / 2.0
            behind = torch.where(pz > n2, 1.0, 0.0)
            sph_v = behind + (1.0 - 2.0 * behind) * v_ratio
        else:
            sph_u = sph_v = zeros
        ndd = n0 * dx + n1 * dy + n2 * dz
        flip = torch.where(ndd > 0.0, -1.0, 1.0)
        nx = torch.where(is_tri, n0 * flip, rx * rmag)
        ny = torch.where(is_tri, n1 * flip, ry * rmag)
        nz = torch.where(is_tri, n2 * flip, rz * rmag)
        uu = torch.where(is_tri, uu_t, sph_u)
        vv = torch.where(is_tri, vv_t, sph_v)

        m = mat[:, mid.long()]                                # (16, L)
        mtype, mior, mtt, mnsq = m[_M_TYPE], m[_M_IOR], m[_M_TEXTYPE], \
            m[_M_NSQ]
        u_c = (uu * mnsq).to(torch.int32)
        v_c = (vv * mnsq).to(torch.int32)
        is_light = ((u_c + v_c) % 2) == 0
        is_chk = mtt == float(TEX_CHECKERBOARD)
        is_grad = mtt == float(TEX_GRADIENT)
        tex_r = torch.where(is_chk, torch.where(is_light, m[_M_LR], m[_M_DR]),
                            torch.where(is_grad, uu, pcol_r))
        tex_g = torch.where(is_chk, torch.where(is_light, m[_M_LG], m[_M_DG]),
                            torch.where(is_grad, vv, pcol_g))
        tex_b = torch.where(is_chk, torch.where(is_light, m[_M_LB], m[_M_DB]),
                            torch.where(is_grad, 0.0, pcol_b))
        if img_rows > 0:
            # K4 (megakernel.py:840-863): the texel replaces the colour
            is_img = (mtt == float(TEX_IMAGE)) & hit
            ir, ig, ib = fetch_image_reference(tex, img_rows, uu, vv,
                                               m[_M_TW], m[_M_TH], m[_M_TROW])
            tex_r = torch.where(is_img, ir, tex_r)
            tex_g = torch.where(is_img, ig, tex_g)
            tex_b = torch.where(is_img, ib, tex_b)

        miss = active & ~hit
        rr = rr + torch.where(miss, tr * sky[0], 0.0)
        rg = rg + torch.where(miss, tg * sky[1], 0.0)
        rb = rb + torch.where(miss, tb * sky[2], 0.0)
        is_em = mtype == float(MAT_EMISSIVE)
        live_hit = active & hit
        em = live_hit & is_em
        rr = rr + torch.where(em, tr * m[_M_EMR], 0.0)
        rg = rg + torch.where(em, tg * m[_M_EMG], 0.0)
        rb = rb + torch.where(em, tb * m[_M_EMB], 0.0)
        absorb = live_hit & ~is_em
        tr = torch.where(absorb, tr * tex_r, tr)
        tg = torch.where(absorb, tg * tex_g, tg)
        tb = torch.where(absorb, tb * tex_b, tb)

        # scatter (megakernel.py:883-961)
        gdotn = gx * nx + gy * ny + gz * nz
        gflip = torch.where(gdotn < 0.0, -1.0, 1.0)
        ax_, ay_, az_ = nx + gx * gflip, ny + gy * gflip, nz + gz * gflip
        dinv = torch.rsqrt(2.0 + 2.0 * torch.abs(gdotn))
        dfx, dfy, dfz = ax_ * dinv, ay_ * dinv, az_ * dinv
        ddn = dx * nx + dy * ny + dz * nz
        sx = dx - 2.0 * ddn * nx
        sy = dy - 2.0 * ddn * ny
        sz = dz - 2.0 * ddn * nz
        refx = dfx + (sx - dfx) * msm
        refy = dfy + (sy - dfy) * msm
        refz = dfz + (sz - dfz) * msm
        rinv = torch.rsqrt(torch.clamp(
            refx * refx + refy * refy + refz * refz, min=1e-24))
        refx, refy, refz = refx * rinv, refy * rinv, refz * rinv
        if has_refractive:
            exiting = ddn > 0.0
            n1_ = torch.where(exiting, mior, ior)
            exit_ior = ones if fix_exit_ior else ior
            n2_ = torch.where(exiting, exit_ior, mior)
            sgn = torch.where(exiting, 1.0, -1.0)
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
            rfx = rnx * cos2 + pfx * sin2
            rfy = rny * cos2 + pfy * sin2
            rfz = rnz * cos2 + pfz * sin2
            is_refr = mtype == float(MAT_REFRACTIVE)
            use_refr = is_refr & ~do_reflect
            ndx = torch.where(use_refr, rfx, refx)
            ndy = torch.where(use_refr, rfy, refy)
            ndz = torch.where(use_refr, rfz, refz)
            ior_upd = use_refr if fix_exit_ior else is_refr
            new_ior = torch.where(ior_upd & live_hit, n2_, ior)
        else:
            ndx, ndy, ndz, new_ior = refx, refy, refz, ior

        ox = torch.where(live_hit, px, ox)
        oy = torch.where(live_hit, py, oy)
        oz = torch.where(live_hit, pz, oz)
        dx = torch.where(live_hit, ndx, dx)
        dy = torch.where(live_hit, ndy, dy)
        dz = torch.where(live_hit, ndz, dz)
        ior = new_ior

        continues = live_hit
        if emissive_terminates:
            continues = continues & ~is_em
        if rr_start > 0:
            rr_u = uni(3)
            p = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)),
                            0.05, 1.0)
            eligible = continues & (bounce + 1 >= rr_start)
            survive = rr_u < p
            boost = eligible & survive
            inv_p = 1.0 / p
            tr = torch.where(boost, tr * inv_p, tr)
            tg = torch.where(boost, tg * inv_p, tg)
            tb = torch.where(boost, tb * inv_p, tb)
            continues = continues & (~eligible | survive)
        path_end = active & (~continues | (bounce + 1 >= limit))

        banked = torch.stack([torch.where(path_end, rr, 0.0),
                              torch.where(path_end, rg, 0.0),
                              torch.where(path_end, rb, 0.0)])
        sums.scatter_add_(1, cur_k[None, None, :].expand(3, 1, n_lanes),
                          banked[:, None, :])
        sample = torch.where(path_end, sample + 1, sample)
        bounce = torch.where(path_end, 0,
                             torch.where(active, bounce + 1, bounce))
        adv = path_end & (sample == (cur_k + 1) * spp)
        cur_k = torch.clamp(cur_k + adv.to(torch.int64), max=k_pp - 1)
        sel = cur_k[None, None, :].expand(3, 1, n_lanes)
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

    inv_spp = float(np.float32(1.0 / float(spp)))
    out = torch.empty((5, n_pad), dtype=f32, device=dev)
    flat = pix.reshape(-1)
    for c in range(3):
        out[c, flat] = (sums[c] * inv_spp).reshape(-1)
    seg_blocks = torch.zeros((k_pp, n_lanes), dtype=f32, device=dev)
    seg_blocks[0] = segs
    out[3, flat] = seg_blocks.reshape(-1)
    out[4, flat] = depth.reshape(-1)
    return out


def _mega_cuda(ps, mat, o, d, seed, *, tex, img_rows, pixpack, spp, limit,
               antialias, sky, emissive_terminates, fix_exit_ior,
               need_sphere_uv, has_refractive, rr_start) -> torch.Tensor:
    """Launch rt_megakernel on the current stream; (5, n_pad) outputs."""
    from ..kernels import build
    n_pad = o.shape[1]
    out = torch.empty((5, n_pad), dtype=torch.float32, device=o.device)
    w0, w1, tile_offset = seed
    args = build.MegaArgs(
        scene=build.scene_args(ps), o=build.ptrs3(o), d=build.ptrs3(d),
        out=(ctypes.c_void_p * 5)(*[out[i].data_ptr() for i in range(5)]),
        mat=mat.data_ptr(), n_mat=mat.shape[1], tex=tex.data_ptr(),
        img_rows=img_rows, seed_w0=w0, seed_w1=w1,
        tile_offset=tile_offset, n_tiles=n_pad // (MEGA_TILE * pixpack),
        pixpack=pixpack, spp=spp, limit=limit, antialias=int(antialias),
        rr_start=rr_start, emissive_terminates=int(emissive_terminates),
        fix_exit_ior=int(fix_exit_ior), need_sphere_uv=int(need_sphere_uv),
        has_refractive=int(has_refractive),
        inv_spp=float(np.float32(1.0 / float(spp))),
        sky=(ctypes.c_float * 3)(*sky))
    lib = build.load()
    rc = lib.rt_megakernel(ctypes.byref(args),
                           ctypes.c_void_p(build.stream(o.device)))
    build.check(lib, rc, "rt_megakernel")
    global LAUNCHES, IMAGE_LAUNCHES
    LAUNCHES += 1
    if img_rows > 0:
        IMAGE_LAUNCHES += 1
    return out


class MegaScene:
    """A scene packed for the megakernel: the sweep pools, the material
    rows, the texel plane and the static flags, on the scene's device.
    Build once per scene and reuse across frames."""

    def __init__(self, scene):
        if not supports(scene):
            raise ValueError(f"texel plane of {scene.img_rows} rows is too "
                             "big to index with int32")
        self.packed = sweep.pack(scene)
        self.mat = pack_materials(scene)
        self.tex = pack_textures(scene)
        self.img_rows = int(scene.img_rows)
        self.need_sphere_uv = bool(scene.needs_sphere_uv)
        self.has_refractive = bool(scene.has_refractive)

    @property
    def device(self) -> torch.device:
        return self.packed.device


def fetch_image(ms: MegaScene, u: torch.Tensor, v: torch.Tensor,
                mat_id: torch.Tensor):
    """K4 alone: the texel of material ``mat_id`` at (u, v) for N queries,
    as the megakernel fetches it on an image hit. ``u``, ``v``: (N,)
    float32; ``mat_id``: (N,) int32, clamped to the material table.
    Returns (3, N) float32. CPU tensors take the plain version; CUDA
    tensors launch ``rt_fetch_image`` (or raise)."""
    n = u.shape[0]
    if (u.dtype != torch.float32 or v.dtype != torch.float32
            or mat_id.dtype != torch.int32 or u.shape != (n,)
            or v.shape != (n,) or mat_id.shape != (n,)):
        raise ValueError("u, v must be (N,) float32 and mat_id (N,) int32")
    if not (u.device == v.device == mat_id.device == ms.device):
        raise ValueError("queries and scene must share one device")
    if ms.img_rows == 0:
        raise ValueError("the scene has no image texture")
    if u.device.type == "cpu":
        mid = mat_id.long().clamp(0, ms.mat.shape[1] - 1)
        m = ms.mat[:, mid]
        return torch.stack(fetch_image_reference(
            ms.tex, ms.img_rows, u, v, m[_M_TW], m[_M_TH], m[_M_TROW]))
    if u.device.type != "cuda":
        raise ValueError(f"no image fetch for device {u.device}")
    from ..kernels import build
    out = torch.empty((3, n), dtype=torch.float32, device=u.device)
    u, v, mat_id = u.contiguous(), v.contiguous(), mat_id.contiguous()
    args = build.FetchArgs(
        tex=ms.tex.data_ptr(), img_rows=ms.img_rows, mat=ms.mat.data_ptr(),
        n_mat=ms.mat.shape[1], u=u.data_ptr(), v=v.data_ptr(),
        mat_id=mat_id.data_ptr(),
        out=(ctypes.c_void_p * 3)(*[out[i].data_ptr() for i in range(3)]),
        n=n)
    lib = build.load()
    rc = lib.rt_fetch_image(ctypes.byref(args),
                            ctypes.c_void_p(build.stream(u.device)))
    build.check(lib, rc, "rt_fetch_image")
    global FETCH_LAUNCHES
    FETCH_LAUNCHES += 1
    return out


def mega_inputs(ms: MegaScene, settings: RenderSettings, o: torch.Tensor,
                d: torch.Tensor, frame_key: np.ndarray, tile_offset: int = 0,
                pixpack=None):
    """Check (3, N) rays and turn them into the arguments that
    ``mega_reference`` and the kernel take: (o_pad, d_pad, seed, kwargs)."""
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != 3:
            raise ValueError(f"{name} must be (3, N) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if o.shape != d.shape or o.device != d.device or ms.device != o.device:
        raise ValueError(f"rays on {o.device} / {d.device}, scene on "
                         f"{ms.device}: all must share one device")
    k = resolve_pixpack(settings, pixpack)
    o_p, d_p = pad_rays(o, d, k)
    seed = rng.seed_words(frame_key, tile_offset)
    kw = dict(tex=ms.tex, img_rows=ms.img_rows,
              pixpack=k, spp=int(settings.rays_per_pixel),
              limit=int(settings.reflect_limit),
              antialias=bool(settings.antialias),
              sky=tuple(float(c) for c in settings.sky_colour),
              emissive_terminates=bool(settings.emissive_terminates),
              fix_exit_ior=bool(settings.fix_exit_ior),
              need_sphere_uv=ms.need_sphere_uv,
              has_refractive=ms.has_refractive,
              rr_start=int(settings.russian_roulette))
    return o_p, d_p, seed, kw


def render_sample_mean_mega(scene, settings: RenderSettings,
                            o: torch.Tensor, d: torch.Tensor,
                            frame_key: np.ndarray, tile_offset: int = 0,
                            want_depth: bool = False, pixpack=None):
    """Full-frame megakernel sampler over (3, N) primary rays.

    ``scene`` is a SceneArrays or a MegaScene built from one. Returns
    ((3, N) mean radiance, segments) or, with ``want_depth``, also the
    (N,) primary-hit depth. Segments count every loop iteration of an
    active lane (one traced ray segment each) over the lanes whose first
    pixel lies in [0, N), as a float64 0-dim tensor on the rays' device.
    """
    ms = scene if isinstance(scene, MegaScene) else MegaScene(scene)
    o_p, d_p, seed, kw = mega_inputs(ms, settings, o, d, frame_key,
                                     tile_offset, pixpack)
    n = o.shape[1]
    if o.device.type == "cpu":
        out = mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    elif o.device.type == "cuda":
        out = _mega_cuda(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    else:
        raise ValueError(f"no megakernel for device {o.device}")
    mean = out[:3, :n]
    segs = out[3, :n].sum(dtype=torch.float64)
    if want_depth:
        return mean, segs, out[4, :n]
    return mean, segs
