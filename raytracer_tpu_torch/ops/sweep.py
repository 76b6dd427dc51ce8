"""Nearest hit over the scene pools, and the layouts the kernels read.

Port of ``raytracer_tpu/ops/sweep.py``: the colour30 and smooth|mat
codecs, ``pack_scene`` and ``pack_param_planes`` (bitwise the same arrays),
and the sweep's hit math. On the TPU the sweep walks a tile of rays through
cluster gates (K2, sweep.py:491) and fetches the winner's parameters with
lane gathers (K3, sweep.py:1170). Here both are ``__device__`` code: a
group of G threads walks the cluster arrays in index order for one ray,
the boxes and a leaf's primitives strided over the group (``walk_pool``
in ``csrc/sweep.cuh``, which the wavefront kernels K5 and K6 run too).
``nearest_hit`` runs them alone over a batch of rays
(``rt_nearest_hit``); ``nearest_hit_reference`` is its plain version.
``group_size`` is the rules' form, which picks G from the rays (or the
megakernel's lane slots) and the threads the card keeps resident, and
``rule_group`` applies it for one kernel: ``nearest_group`` is
rt_nearest_hit's rule, ``megakernel.mega_group`` rt_megakernel's,
``intersect_cuda.resolve_group`` and ``blocked_group`` K5's and K6's.

The hit contract, kept by both versions:

- rays carry unit directions, so spheres use the half-b quadratic
  ``t = h - sqrt(h^2 - c)``; a miss makes sqrt NaN, and NaN fails every
  compare (padding spheres carry ``cr2 = 1e30``);
- triangles use the Woop rows with the megakernel's FAST_DIV reciprocal:
  ``1 / bf16(dw)`` in float32 plus one Newton step, which is what
  ``pl.reciprocal(approx=True)`` evaluates to in Pallas interpret mode;
  all-zero padding rows give ``t = NaN``;
- ``t > 1e-6``, and the winner is the first hit in the order (t,
  is_triangle, primitive index): an exact tie goes to the sphere, then to
  the lower index, whatever order the kernel visits the boxes in. The
  plain version's argmin over each pool, with ``is_tri = t_t < s_t``, is
  that order.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..kernels import build

EPS = 1e-6
INF = 1e30
LANES = 128
LEAF_TARGET = 32   # target primitives per BVH leaf cluster
UNROLL = 4         # leaf sizes are multiples of this (scene layout)

# sphere f32 rows: centre x, y, z, |c|^2 - r^2; i32 rows: colour30, smooth|mat
S_F32_ROWS = 4
S_I32_ROWS = 2
# triangle f32 rows
T_WU = 0          # 4 rows: Woop u row [r | -r.p0]
T_WV = 4          # 4 rows
T_WW = 8          # 4 rows
T_NRM = 12        # 3 rows: unit geometric normal
T_CULL = 15       # 3 rows: one-way cull normal (zero = two-sided)
T_UV = 18         # 6 rows: uv0.x uv0.y uv1.x uv1.y uv2.x uv2.y
T_F32_ROWS = 24
T_I32_ROWS = 2

# Threads that share one ray in rt_nearest_hit and one lane slot in
# rt_megakernel (the kernels' template instances).
GROUPS = (1, 2, 4, 8)
# Waves of resident threads rt_nearest_hit's rule fills, by the scene's
# gate depth (0: every pool flat, 1: clusters, 2: supers), from the
# measured sweep (scripts/k1_groups.py sweep, PERF.md): over supers the
# split walk wins even at 1M rays, 55 waves at G = 8.
NEAREST_WAVES = {0: 1, 1: 4, 2: 64}


def gate_depth(ps) -> int:
    """Gate levels of the scene's deepest pool: 2 with supers, 1 with
    clusters, 0 when every pool is swept whole."""
    if ps.n_sph_sup > 0 or ps.n_tri_sup > 0:
        return 2
    return 1 if ps.n_sph_cl > 0 or ps.n_tri_cl > 0 else 0


def group_size(slots: int, resident, waves: float) -> int:
    """G for ``slots`` lane slots or rays: the largest G of GROUPS whose
    ``slots * G`` threads fit in ``waves`` waves of the threads the card
    keeps resident for that arm, ``resident[G]``; 1 when none does."""
    for g in sorted(GROUPS, reverse=True):
        if slots * g <= waves * resident[g]:
            return g
    return 1


def check_group(group) -> None:
    if group is not None and group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group}")


def rule_group(kind: int, slots: int, waves: float, group=None) -> int:
    """A kernel's group rule: ``group`` when given (checked), else
    ``group_size`` over the threads the current card keeps resident for
    each G of kernel ``kind`` (``build.KIND_*``, rt_occupancy)."""
    check_group(group)
    if group is not None:
        return group
    resident = {g: build.resident_threads(kind, g) for g in GROUPS}
    return group_size(slots, resident, waves)


def nearest_group(n: int, ps, group=None) -> int:
    """G for rt_nearest_hit over ``n`` rays of ``ps``: ``group`` when
    given, else the rule's, with NEAREST_WAVES of the gate depth."""
    return rule_group(build.KIND_NEAREST, n, NEAREST_WAVES[gate_depth(ps)],
                      group)


def leaf_size(n: int) -> int:
    """Per-pool leaf size: n spread evenly over ceil(n / LEAF_TARGET)
    leaves, rounded up to the UNROLL width."""
    leaves = -(-n // LEAF_TARGET)
    per = -(-n // leaves)
    return -(-per // UNROLL) * UNROLL


def quantise_colour(c):
    """Host-side 10-bit albedo quantisation (clamped to [0, 1])."""
    q = np.round(np.clip(np.asarray(c, np.float32), 0.0, 1.0) * 1023.0)
    return q.astype(np.float32) * np.float32(1.0 / 1023.0)


def quantise_smooth(s):
    """Host-side 8-bit smoothness quantisation (clamped to [0, 1])."""
    q = np.round(np.clip(np.asarray(s, np.float32), 0.0, 1.0) * 255.0)
    return q.astype(np.float32) * np.float32(1.0 / 255.0)


def encode_colour30(col: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 quantised colour -> int32 with 10 bits per channel."""
    q = torch.round(torch.clamp(col, 0.0, 1.0) * 1023.0).to(torch.int32)
    return (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]


def decode_colour30(pa: torch.Tensor):
    """int32 packed colour -> (r, g, b) f32."""
    s = float(np.float32(1.0 / 1023.0))
    r = ((pa >> 20) & 1023).to(torch.float32) * s
    g = ((pa >> 10) & 1023).to(torch.float32) * s
    b = (pa & 1023).to(torch.float32) * s
    return r, g, b


def encode_smooth_mat(smooth: torch.Tensor, mat_id: torch.Tensor):
    """(smoothness f32 quantised, mat id) -> int32 smooth8<<16 | mat."""
    q = torch.round(torch.clamp(smooth, 0.0, 1.0) * 255.0).to(torch.int32)
    return (q << 16) | mat_id.to(torch.int32)


def decode_smooth_mat(pb: torch.Tensor):
    """int32 -> (smoothness f32, mat id i32)."""
    smooth = ((pb >> 16) & 255).to(torch.float32) * float(
        np.float32(1.0 / 255.0))
    return smooth, pb & 0xFFFF


def pack_scene(scene):
    """SceneArrays -> the sweep's row matrices (sweep.py:412).

    Returns (sph_f32 (4, S), sph_i32 (2, S), tri_f32 (24, T),
    tri_i32 (2, T), sph_clusters, tri_clusters, sph_supers, tri_supers,
    sph_cell_order, tri_cell_order, cell_grid); empty cluster tables are
    replaced by one zero row.
    """
    c = scene.sph_center
    r = scene.sph_radius
    cr2 = torch.where(
        r > 0.0,
        (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]) - r * r,
        torch.full_like(r, INF))
    sph_f32 = torch.stack([c[:, 0], c[:, 1], c[:, 2], cr2])
    sph_i32 = torch.stack([
        encode_colour30(scene.sph_colour),
        encode_smooth_mat(scene.sph_smooth, scene.sph_mat),
    ])
    tri_f32 = torch.cat([
        scene.tri_wu.T, scene.tri_wv.T, scene.tri_ww.T,
        scene.tri_normal.T, scene.tri_cull.T,
        scene.tri_uv0.T, scene.tri_uv1.T, scene.tri_uv2.T,
    ], dim=0)
    tri_i32 = torch.stack([
        encode_colour30(scene.tri_colour),
        encode_smooth_mat(scene.tri_smooth, scene.tri_mat),
    ])

    def clusters_or_dummy(cl):
        if cl.shape[0] > 0:
            return cl
        return torch.zeros((1, 8), dtype=torch.float32, device=cl.device)

    return (sph_f32.contiguous(), sph_i32.contiguous(),
            tri_f32.contiguous(), tri_i32.contiguous(),
            clusters_or_dummy(scene.sph_clusters),
            clusters_or_dummy(scene.tri_clusters),
            clusters_or_dummy(scene.sph_supers),
            clusters_or_dummy(scene.tri_supers),
            scene.sph_cell_order, scene.tri_cell_order, scene.cell_grid)


def param_rows(n: int) -> int:
    """Lane-padded rows one primitive-parameter plane needs for n prims."""
    return max(1, -(-n // LANES))


def pack_param_planes(scene):
    """Winner-parameter planes (sweep.py:1136): row ``p * rows + r``,
    lane ``l`` holds parameter ``p`` of primitive ``r * 128 + l``.

    Returns (sphp_f: centre xyz (3 * rows_s, 128) f32,
    sphp_i: colour30, smooth|mat (2 * rows_s, 128) i32,
    trip_f: normal xyz [+ uv0..uv2 when needs_tri_uv] (3|9 * rows_t, 128),
    trip_i: colour30, smooth|mat (2 * rows_t, 128) i32).
    """
    def to_plane(col):
        rows = param_rows(col.shape[0])
        out = torch.zeros(rows * LANES, dtype=col.dtype, device=col.device)
        out[:col.shape[0]] = col
        return out.reshape(rows, LANES)

    sphp_f = torch.cat([to_plane(scene.sph_center[:, c]) for c in range(3)])
    sphp_i = torch.cat([
        to_plane(encode_colour30(scene.sph_colour)),
        to_plane(encode_smooth_mat(scene.sph_smooth, scene.sph_mat)),
    ])
    tri_cols = [scene.tri_normal[:, c] for c in range(3)]
    if scene.needs_tri_uv:
        tri_cols += [scene.tri_uv0[:, 0], scene.tri_uv0[:, 1],
                     scene.tri_uv1[:, 0], scene.tri_uv1[:, 1],
                     scene.tri_uv2[:, 0], scene.tri_uv2[:, 1]]
    trip_f = torch.cat([to_plane(c) for c in tri_cols])
    trip_i = torch.cat([
        to_plane(encode_colour30(scene.tri_colour)),
        to_plane(encode_smooth_mat(scene.tri_smooth, scene.tri_mat)),
    ])
    return sphp_f, sphp_i, trip_f, trip_i


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Everything the sweep reads, on one device, contiguous.

    Cluster and super tables hold at least one row; ``n_*`` are the real
    counts (0 = that level is absent)."""

    sph_f: torch.Tensor
    sph_i: torch.Tensor
    tri_f: torch.Tensor
    tri_i: torch.Tensor
    sph_cl: torch.Tensor
    tri_cl: torch.Tensor
    sph_sup: torch.Tensor
    tri_sup: torch.Tensor
    sphp_f: torch.Tensor
    sphp_i: torch.Tensor
    trip_f: torch.Tensor
    trip_i: torch.Tensor
    n_sph: int
    n_tri: int
    n_sph_cl: int
    n_tri_cl: int
    n_sph_sup: int
    n_tri_sup: int
    sph_leaf: int
    tri_leaf: int
    rows_s: int
    rows_t: int
    has_one_way: bool
    needs_tri_uv: bool

    @property
    def device(self) -> torch.device:
        return self.sph_f.device


def pack(scene) -> PackedScene:
    """Pack ``scene`` for the sweep on the scene's device."""
    (sph_f, sph_i, tri_f, tri_i, sph_cl, tri_cl, sph_sup, tri_sup,
     _, _, _) = pack_scene(scene)
    sphp_f, sphp_i, trip_f, trip_i = pack_param_planes(scene)
    return PackedScene(
        sph_f=sph_f, sph_i=sph_i, tri_f=tri_f, tri_i=tri_i,
        sph_cl=sph_cl.contiguous(), tri_cl=tri_cl.contiguous(),
        sph_sup=sph_sup.contiguous(), tri_sup=tri_sup.contiguous(),
        sphp_f=sphp_f.contiguous(), sphp_i=sphp_i.contiguous(),
        trip_f=trip_f.contiguous(), trip_i=trip_i.contiguous(),
        n_sph=int(scene.sph_center.shape[0]),
        n_tri=int(scene.tri_v0.shape[0]),
        n_sph_cl=int(scene.sph_clusters.shape[0]),
        n_tri_cl=int(scene.tri_clusters.shape[0]),
        n_sph_sup=int(scene.sph_supers.shape[0]),
        n_tri_sup=int(scene.tri_supers.shape[0]),
        sph_leaf=int(scene.sph_leaf), tri_leaf=int(scene.tri_leaf),
        rows_s=param_rows(int(scene.sph_center.shape[0])),
        rows_t=param_rows(int(scene.tri_v0.shape[0])),
        has_one_way=bool(scene.has_one_way),
        needs_tri_uv=bool(scene.needs_tri_uv))


def approx_reciprocal(x: torch.Tensor) -> torch.Tensor:
    """``pl.reciprocal(x, approx=True)`` as Pallas interpret mode evaluates
    it: the float32 reciprocal of ``x`` rounded to bfloat16."""
    return 1.0 / x.to(torch.bfloat16).to(torch.float32)


def fast_recip(x: torch.Tensor) -> torch.Tensor:
    """FAST_DIV reciprocal: ``approx_reciprocal`` refined by one Newton
    step. ``0`` gives ``inf`` and then NaN, so zero rows never hit."""
    r0 = approx_reciprocal(x)
    return r0 * (2.0 - x * r0)


# Rays per chunk of the plain sweep: bounds its (rays, primitives) temporaries.
_CHUNK_ELEMS = 1 << 24


def sphere_t(sph_f: torch.Tensor, ox, oy, oz, dx, dy, dz) -> torch.Tensor:
    """t of (n, 1) unit-direction ray columns against the (4, m) sphere
    rows (sweep.py:821-860): (n, m), INF where the ray misses."""
    cx, cy, cz, cr2 = (sph_f[k][None, :] for k in range(4))
    ddo = dx * ox + dy * oy + dz * oz
    osq = ox * ox + oy * oy + oz * oz
    dc = dx * cx + dy * cy + dz * cz
    oc = ox * cx + oy * cy + oz * cz
    h = dc - ddo
    cq = (cr2 + osq) - (oc + oc)
    disc = h * h - cq
    t = h - torch.sqrt(disc)
    return torch.where(t > EPS, t, INF)


def triangle_tuv(tri_f: torch.Tensor, has_one_way: bool, ox, oy, oz, dx,
                 dy, dz, fast_div: bool = True):
    """(t, u, v) of (n, 1) ray columns against the (24, m) triangle rows
    (sweep.py:961-1032), each (n, m); t is INF where the ray misses.
    ``fast_div`` picks the megakernel's FAST_DIV reciprocal; False divides
    exactly, as the wavefront kernels do (hazard H2)."""
    w = [tri_f[k][None, :] for k in range(T_F32_ROWS)]
    ow = w[T_WW] * ox + w[T_WW + 1] * oy + w[T_WW + 2] * oz + w[T_WW + 3]
    dw = w[T_WW] * dx + w[T_WW + 1] * dy + w[T_WW + 2] * dz
    t = -ow * fast_recip(dw) if fast_div else -ow / dw
    ou = w[T_WU] * ox + w[T_WU + 1] * oy + w[T_WU + 2] * oz + w[T_WU + 3]
    du = w[T_WU] * dx + w[T_WU + 1] * dy + w[T_WU + 2] * dz
    u = ou + t * du
    ov = w[T_WV] * ox + w[T_WV + 1] * oy + w[T_WV + 2] * oz + w[T_WV + 3]
    dv = w[T_WV] * dx + w[T_WV + 1] * dy + w[T_WV + 2] * dz
    v = ov + t * dv
    valid = (t > EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    if has_one_way:
        cull = (w[T_CULL] * dx + w[T_CULL + 1] * dy + w[T_CULL + 2] * dz)
        valid &= cull >= 0.0
    return torch.where(valid, t, INF), u, v


def _sweep_chunk(sph_f: torch.Tensor, tri_f: torch.Tensor,
                 has_one_way: bool, ox, oy, oz, dx, dy, dz,
                 fast_div: bool = True):
    """Plain nearest hit for (n, 1) ray columns: every primitive is tested
    (no cluster gate), which gives the gated sweep's winner except where a
    ray hits a primitive without entering its padded box."""
    t = sphere_t(sph_f, ox, oy, oz, dx, dy, dz)
    s_idx = torch.argmin(t, dim=1)
    s_t = torch.gather(t, 1, s_idx[:, None])[:, 0]

    t, u, v = triangle_tuv(tri_f, has_one_way, ox, oy, oz, dx, dy, dz,
                           fast_div)
    t_idx = torch.argmin(t, dim=1)
    t_t = torch.gather(t, 1, t_idx[:, None])[:, 0]
    bu = torch.gather(u, 1, t_idx[:, None])[:, 0]
    bv = torch.gather(v, 1, t_idx[:, None])[:, 0]

    is_tri = t_t < s_t
    bt = torch.where(is_tri, t_t, s_t)
    s_code = torch.where(s_t < INF, s_idx * 2, 0)
    code = torch.where(is_tri, t_idx * 2 + 1, s_code).to(torch.int32)
    zero = torch.zeros_like(bt)
    bu = torch.where(is_tri, bu, zero)
    bv = torch.where(is_tri, bv, zero)
    return bt, code, bu, bv


def fetch_winner(ps: PackedScene, code: torch.Tensor, bu, bv):
    """K3 (sweep.py:1170): the winner's centre or normal, colour30 and
    smooth|mat by primitive index; triangle barycentrics become the
    texture UV with the reference's argument order (uv0*w + uv1*u + uv2*v,
    src/objects.cu:160,196-199) when the scene needs triangle UVs, else 0.
    Returns (u, v, n0, n1, n2, pa, pb)."""
    prim = (code >> 1).long()
    is_tri = (code & 1) == 1
    s_prim = torch.where(is_tri, 0, prim)
    t_prim = torch.where(is_tri, prim, 0)
    sf = ps.sphp_f.reshape(-1, ps.rows_s * LANES)
    si = ps.sphp_i.reshape(-1, ps.rows_s * LANES)
    tf = ps.trip_f.reshape(-1, ps.rows_t * LANES)
    ti = ps.trip_i.reshape(-1, ps.rows_t * LANES)
    n = [torch.where(is_tri, tf[c][t_prim], sf[c][s_prim]) for c in range(3)]
    pa = torch.where(is_tri, ti[0][t_prim], si[0][s_prim])
    pb = torch.where(is_tri, ti[1][t_prim], si[1][s_prim])
    if ps.needs_tri_uv:
        uvp = [tf[3 + c][t_prim] for c in range(6)]
        w_bar = 1.0 - bu - bv
        tu = uvp[0] * w_bar + uvp[2] * bu + uvp[4] * bv
        tv = uvp[1] * w_bar + uvp[3] * bu + uvp[5] * bv
        zero = torch.zeros_like(bu)
        u = torch.where(is_tri, tu, zero)
        v = torch.where(is_tri, tv, zero)
    else:
        u = torch.zeros_like(bu)
        v = torch.zeros_like(bv)
    return u, v, n[0], n[1], n[2], pa, pb


def nearest_hit_reference(ps: PackedScene, o: torch.Tensor,
                          d: torch.Tensor, fast_div: bool = True):
    """Plain version of ``rt_nearest_hit``: o, d (3, N) float32 with unit
    d -> (t, code, u, v, n0, n1, n2, pa, pb), each (N,). With
    ``fast_div=False`` triangles divide exactly (the plain K5)."""
    n = o.shape[1]
    chunk = max(1, _CHUNK_ELEMS // max(ps.n_sph, ps.n_tri))
    parts = []
    for lo in range(0, n, chunk):
        cols = [x[lo:lo + chunk, None] for x in (*o, *d)]
        bt, code, bu, bv = _sweep_chunk(ps.sph_f, ps.tri_f, ps.has_one_way,
                                        *cols, fast_div=fast_div)
        parts.append((bt, code) + fetch_winner(ps, code, bu, bv))
    return tuple(torch.cat(p) for p in zip(*parts))


def _check_rays(o: torch.Tensor, d: torch.Tensor):
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != 3:
            raise ValueError(f"{name} must be (3, N) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if o.shape != d.shape or o.device != d.device:
        raise ValueError("o and d must match in shape and device")


def nearest_hit(ps: PackedScene, o: torch.Tensor, d: torch.Tensor, *,
                _group=None):
    """Nearest hit + winner parameters for rays o, d (3, N), unit d.

    CPU tensors take ``nearest_hit_reference``; CUDA tensors launch
    ``rt_nearest_hit`` (or raise) with G threads a ray, G by
    ``nearest_group`` (``_group`` forces it, for the tests and
    chip_smoke.py).
    Returns (t, code, u, v, n0, n1, n2, pa, pb), each (N,): t f32
    (1e30 = miss), code i32 = prim * 2 + is_triangle, u/v f32 texture UV
    of a triangle winner, n f32 sphere centre or triangle normal, pa
    colour30 i32, pb smooth|mat i32.
    """
    _check_rays(o, d)
    check_group(_group)
    if o.device.type == "cpu":
        return nearest_hit_reference(ps, o, d)
    if o.device.type != "cuda" or ps.device != o.device:
        raise ValueError(f"rays on {o.device}, scene on {ps.device}: "
                         "rt_nearest_hit needs both on one CUDA device")
    n = o.shape[1]
    o = o.contiguous()
    d = d.contiguous()
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    outs = (torch.empty(n, **f32), torch.empty(n, **i32),
            torch.empty(n, **f32), torch.empty(n, **f32),
            torch.empty(n, **f32), torch.empty(n, **f32),
            torch.empty(n, **f32), torch.empty(n, **i32),
            torch.empty(n, **i32))
    args = build.HitArgs(
        scene=build.scene_args(ps),
        o=build.row_ptrs(o), d=build.row_ptrs(d),
        out=(ctypes.c_void_p * 9)(*[x.data_ptr() for x in outs]), n=n,
        group=nearest_group(n, ps, _group))
    build.launch("rt_nearest_hit", args, o.device)
    return outs
