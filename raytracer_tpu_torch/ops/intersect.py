"""Nearest hit and shading resolve: the JAX package's XLA oracles.

Port of ``raytracer_tpu/ops/intersect.py``: the record types
(``HitRecord``, ``ShadeData``), the backends ``"xla"`` (direct
Moller-Trumbore and the full sphere quadratic) and ``"woop"`` (Woop rows as
(4, N) x (4, T) products) of ``nearest_hit``, and ``resolve_hit``. They are
plain versions for CPU tensors and the tests; a CUDA tensor raises. The
card runs the kernel backend of ops/intersect_cuda.py.
"""

from __future__ import annotations

import dataclasses

import torch

from .sweep import EPS, INF

# Primitive pools are swept in tiles of this size and rays in chunks of
# this size, which bounds the (chunk, tile) temporaries (intersect.py:37-43).
PRIM_TILE = 512
RAY_CHUNK = 32768


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Nearest hit per ray (src/raytracer.cu:18-21)."""

    t: torch.Tensor       # (N,) f32 distance (INF when no hit)
    hit: torch.Tensor     # (N,) bool
    is_tri: torch.Tensor  # (N,) bool (False => sphere)
    idx: torch.Tensor     # (N,) i32 primitive index within its pool


@dataclasses.dataclass(frozen=True)
class ShadeData:
    """Per-ray shading inputs of the nearest hit; colour and smoothness
    are the winner's denormalised parameters."""

    point: torch.Tensor    # (3, N)
    normal: torch.Tensor   # (3, N) reference orientation
    u: torch.Tensor        # (N,)
    v: torch.Tensor        # (N,)
    mat_id: torch.Tensor   # (N,) i32
    colour: torch.Tensor   # (3, N)
    smooth: torch.Tensor   # (N,)


def _mm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, N) x (K, T) -> (N, T), contracting K, in float32."""
    return a.T @ b


def sphere_hit_ts(o, d, centers, radii):
    """(N, S) distances of the nearer root, INF where no hit
    (src/objects.cu:40-79)."""
    c_t = centers.T
    d_dot_c = _mm_t(d, c_t)
    o_dot_c = _mm_t(o, c_t)
    d_dot_o = torch.sum(d * o, dim=0)[:, None]
    o_sq = torch.sum(o * o, dim=0)[:, None]
    a = torch.sum(d * d, dim=0)[:, None]
    c_sq_min_r2 = torch.sum(centers * centers, dim=-1) - radii * radii
    b = -2.0 * (d_dot_c - d_dot_o)
    c = c_sq_min_r2 - 2.0 * o_dot_c + o_sq
    disc = b * b - 4.0 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sqrt_disc) / (2.0 * a)
    valid = (disc >= 0.0) & (t > EPS) & (radii > 0.0)
    return torch.where(valid, t, INF)


def triangle_hit_ts_mt(o, d, scene):
    """Moller-Trumbore (N, T) distances, INF on a miss
    (src/objects.cu:135-163)."""
    v0 = scene.tri_v0[None, :, :]
    e1 = scene.tri_e1[None, :, :]
    e2 = scene.tri_e2[None, :, :]
    dn = d.T[:, None, :]
    on = o.T[:, None, :]
    p_vec = torch.cross(dn.expand(-1, e2.shape[1], -1),
                        e2.expand(dn.shape[0], -1, -1), dim=-1)
    det = torch.sum(e1 * p_vec, dim=-1)
    inv_det = 1.0 / det
    t_vec = on - v0
    u = torch.sum(t_vec * p_vec, dim=-1) * inv_det
    q_vec = torch.cross(t_vec, e1.expand(t_vec.shape[0], -1, -1), dim=-1)
    v = torch.sum(dn * q_vec, dim=-1) * inv_det
    w = 1.0 - u - v
    t = torch.sum(e2 * q_vec, dim=-1) * inv_det
    cull_ok = _mm_t(d, scene.tri_cull.T) >= 0.0
    valid = (t > EPS) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    valid &= scene.tri_valid[None, :] & cull_ok
    return torch.where(valid, t, INF)


def _woop_tile_ts(o_h, d_h, wu, wv, ww, cull, tri_ok):
    """(N, T) distances over one triangle tile from the Woop rows."""
    ou = _mm_t(o_h, wu.T)
    ov = _mm_t(o_h, wv.T)
    ow = _mm_t(o_h, ww.T)
    du = _mm_t(d_h, wu.T)
    dv = _mm_t(d_h, wv.T)
    dw = _mm_t(d_h, ww.T)
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    cull_ok = _mm_t(d_h[:3], cull.T) >= 0.0
    valid = (t > EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    valid &= tri_ok[None, :] & cull_ok
    return torch.where(valid, t, INF)


def _best_over(ts_fn, count: int, n: int, dev):
    """Running best (t, index) over primitive tiles; a later tile wins only
    with a strictly smaller t, so ties keep the first index."""
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    for lo in range(0, count, PRIM_TILE):
        ts = ts_fn(lo, min(lo + PRIM_TILE, count))
        i = torch.argmin(ts, dim=-1)
        t = torch.gather(ts, 1, i[:, None])[:, 0]
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i.to(torch.int32) + lo, best_i)
    return best_t, best_i


def _nearest_hit_chunk(o, d, scene, backend: str) -> HitRecord:
    n = o.shape[1]
    dev = o.device
    sph_t, sph_idx = _best_over(
        lambda lo, hi: sphere_hit_ts(o, d, scene.sph_center[lo:hi],
                                     scene.sph_radius[lo:hi]),
        scene.sph_center.shape[0], n, dev)
    t_count = scene.tri_v0.shape[0]
    o_h = torch.cat([o, torch.ones((1, n), dtype=o.dtype, device=dev)])
    d_h = torch.cat([d, torch.zeros((1, n), dtype=d.dtype, device=dev)])
    if backend == "xla" and t_count <= PRIM_TILE:
        tri_t, tri_idx = _best_over(
            lambda lo, hi: triangle_hit_ts_mt(o, d, scene), t_count, n, dev)
    else:
        tri_t, tri_idx = _best_over(
            lambda lo, hi: _woop_tile_ts(
                o_h, d_h, scene.tri_wu[lo:hi], scene.tri_wv[lo:hi],
                scene.tri_ww[lo:hi], scene.tri_cull[lo:hi],
                scene.tri_valid[lo:hi]), t_count, n, dev)
    # ties go to the sphere (src/raytracer.cu:36)
    is_tri = tri_t < sph_t
    t = torch.where(is_tri, tri_t, sph_t)
    idx = torch.where(is_tri, tri_idx, sph_idx)
    return HitRecord(t=t, hit=t < INF, is_tri=is_tri, idx=idx)


def _require_cpu(o: torch.Tensor, what: str) -> None:
    if o.device.type != "cpu":
        raise ValueError(
            f"{what} is a plain CPU oracle; rays on {o.device} take the "
            "kernel backend ('pallas', ops/intersect_cuda.py)")


def nearest_hit(o: torch.Tensor, d: torch.Tensor, scene,
                backend: str = "woop") -> HitRecord:
    """Nearest hit over every primitive; ``o``/``d`` are (3, N) CPU
    tensors (intersect.py:200-227). ``backend``: "woop" or "xla"."""
    if backend not in ("woop", "xla"):
        raise ValueError(f"unknown oracle backend {backend!r}")
    _require_cpu(o, "nearest_hit")
    recs = [_nearest_hit_chunk(o[:, lo:lo + RAY_CHUNK],
                               d[:, lo:lo + RAY_CHUNK], scene, backend)
            for lo in range(0, o.shape[1], RAY_CHUNK)]
    return HitRecord(*(torch.cat([getattr(r, f.name) for r in recs])
                       for f in dataclasses.fields(HitRecord)))


def resolve_hit(o: torch.Tensor, d: torch.Tensor, scene,
                rec: HitRecord) -> ShadeData:
    """Normals, UVs and material of each ray's nearest primitive
    (intersect.py:308-390): spheres keep the outward normal, triangles
    face against the ray."""
    _require_cpu(o, "resolve_hit")
    safe_t = torch.where(rec.hit, rec.t, 0.0)
    point = o + d * safe_t[None, :]
    tri_i = torch.where(rec.is_tri, rec.idx, 0).long()
    sph_i = torch.where(rec.is_tri, 0, rec.idx).long()

    sc = scene.sph_center.T
    cx, cy, cz = sc[0][sph_i], sc[1][sph_i], sc[2][sph_i]
    radius = torch.clamp(scene.sph_radius[sph_i], min=1e-12)
    inv_r = 1.0 / radius
    relx = (point[0] - cx) * inv_r
    rely = (point[1] - cy) * inv_r
    relz = (point[2] - cz) * inv_r
    rmag = torch.sqrt(relx * relx + rely * rely + relz * relz)
    sph_nx, sph_ny, sph_nz = relx / rmag, rely / rmag, relz / rmag
    theta = torch.asin(torch.clamp(rely, -1.0, 1.0))
    phi = torch.acos(torch.clamp(relx, -1.0, 1.0))
    sph_u = (theta + torch.pi / 2.0) / torch.pi
    v_ratio = (1.0 - phi / torch.pi) / 2.0
    behind = (point[2] > cz).to(torch.float32)
    sph_v = behind + (1.0 - 2.0 * behind) * v_ratio

    wu = scene.tri_wu.T
    wv = scene.tri_wv.T
    wu0, wu1, wu2, wu3 = (wu[k][tri_i] for k in range(4))
    wv0, wv1, wv2, wv3 = (wv[k][tri_i] for k in range(4))
    ou = wu0 * o[0] + wu1 * o[1] + wu2 * o[2] + wu3
    ov = wv0 * o[0] + wv1 * o[1] + wv2 * o[2] + wv3
    du = wu0 * d[0] + wu1 * d[1] + wu2 * d[2]
    dv = wv0 * d[0] + wv1 * d[1] + wv2 * d[2]
    u_b = ou + safe_t * du
    v_b = ov + safe_t * dv
    w_b = 1.0 - u_b - v_b
    uv0, uv1, uv2 = scene.tri_uv0.T, scene.tri_uv1.T, scene.tri_uv2.T
    tri_u = uv0[0][tri_i] * w_b + uv1[0][tri_i] * u_b + uv2[0][tri_i] * v_b
    tri_v = uv0[1][tri_i] * w_b + uv1[1][tri_i] * u_b + uv2[1][tri_i] * v_b
    tn = scene.tri_normal.T
    nx, ny, nz = tn[0][tri_i], tn[1][tri_i], tn[2][tri_i]
    n_dot_d = nx * d[0] + ny * d[1] + nz * d[2]
    flip = 1.0 - 2.0 * (n_dot_d > 0.0).to(torch.float32)

    it = rec.is_tri
    normal = torch.stack([torch.where(it, nx * flip, sph_nx),
                          torch.where(it, ny * flip, sph_ny),
                          torch.where(it, nz * flip, sph_nz)])
    u = torch.where(it, tri_u, sph_u)
    v = torch.where(it, tri_v, sph_v)
    mat_id = torch.where(it, scene.tri_mat[tri_i], scene.sph_mat[sph_i])
    tcol, scol = scene.tri_colour.T, scene.sph_colour.T
    colour = torch.stack([torch.where(it, tcol[c][tri_i], scol[c][sph_i])
                          for c in range(3)])
    smooth = torch.where(it, scene.tri_smooth[tri_i],
                         scene.sph_smooth[sph_i])
    return ShadeData(point=point, normal=normal, u=u, v=v, mat_id=mat_id,
                     colour=colour, smooth=smooth)
