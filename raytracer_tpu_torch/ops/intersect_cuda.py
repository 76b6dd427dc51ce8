"""Wavefront nearest hit + shading resolve on the card: K5 and K6.

Port of ``raytracer_tpu/ops/intersect_pallas.py``. The wavefront samplers
hand a batch of rays to one of two CUDA kernels (csrc/) and resolve the
shading data with torch ops after it:

- **K5, ``rt_hit_resolve``** (replaces ``intersect_pallas._kernel``): one
  thread per ray walks the scene's own cluster arrays (supers -> clusters
  -> leaves, per-thread gates, index order) with exact triangle division,
  then loads the winner's parameters and decodes its material id, colour
  and smoothness. Plain version: ``hit_resolve_reference``.
- **K6, ``rt_hit_resolve_blocked``** (replaces ``_kernel_blocked``): for
  scenes past the TPU's SMEM budget (``fits_smem``), the JAX package
  streams 4096-sphere / 1024-triangle blocks into SMEM behind block-union,
  super and cluster gates. The kernel keeps that design: one CTA per ray
  tile pops blocks near-first, votes on entry, copies an entered block's
  pool words into shared memory and walks it per thread. Plain version:
  ``hit_resolve_blocked_reference``, which brute-forces every block of
  the same blocked tables and merges the block winners.

``blocked_tables`` builds the blocked layout exactly as
``_run_kernel_blocked`` does (padded pools, poisoned padding spheres,
synthesised leaf boxes for clusterless pools, block unions, per-block
supers, NaN rows for inverted boxes); the tests hold it array-equal to
what JAX hands its pallas_call. JAX's per-cell static block order
(``border``/``bgrid``) feeds only its ``RAYTRACER_BLOCK_NEARFIRST=0``
arm; the port pops near-first, JAX's default, and builds neither.

Both routes share the torch ops around the kernels (padding, direction
rsqrt, t rescale, the resolve), so a kernel and its plain version see the
same inputs. A CUDA tensor launches the kernel or raises; the plain
versions run on CPU tensors, or on any device when ``plain=True`` (how the
card holds the kernels against them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .intersect import HitRecord, ShadeData
from .sweep import (INF, LANES, S_F32_ROWS, S_I32_ROWS, T_F32_ROWS,
                    T_I32_ROWS, T_NRM, T_UV, PackedScene, _check_rays,
                    _sweep_chunk, decode_colour30, decode_smooth_mat,
                    nearest_hit_reference, pack, pack_scene)

RAY_TILE = 32 * LANES    # rays are padded to whole 4096-ray tiles
SPH_BLOCK = 4096         # spheres per block of the blocked layout
TRI_BLOCK = 1024         # triangles per block
SUP_GROUP = 16           # leaf clusters per in-block super
S_CR2 = 3                # sphere row |c|^2 - r^2 (poisoned with INF)
# The TPU's SMEM budget (sweep.py:304): scenes past it take K6, as in JAX.
SMEM_BUDGET = 800_000

# Launches of rt_hit_resolve (K5) and rt_hit_resolve_blocked (K6).
LAUNCHES = 0
BLOCKED_LAUNCHES = 0


def smem_bytes(scene) -> int:
    """Bytes of TPU SMEM the resident layout needs (sweep.py:307-328).
    The port has no lane-cluster tables; each counts as one row, as the
    JAX formula counts an empty table."""
    s = int(scene.sph_center.shape[0])
    t = int(scene.tri_v0.shape[0])
    rows = (s * (S_F32_ROWS + S_I32_ROWS)
            + t * (T_F32_ROWS + T_I32_ROWS)
            + 8 * (max(int(scene.sph_clusters.shape[0]), 1)
                   + max(int(scene.tri_clusters.shape[0]), 1)
                   + max(int(scene.sph_supers.shape[0]), 1)
                   + max(int(scene.tri_supers.shape[0]), 1)
                   + 1 + 1)
            + int(scene.sph_cell_order.shape[0])
            + int(scene.tri_cell_order.shape[0])
            + 16 * int(scene.mat_type.shape[0]) + 16)
    return rows * 4


def fits_smem(scene) -> bool:
    return smem_bytes(scene) <= SMEM_BUDGET


# -- the blocked layout of K6 (intersect_pallas.py:443-680) ------------------

_FILLER = (INF, INF, INF, -INF, -INF, -INF, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class BlockedTables:
    """Everything K6 reads, on one device, contiguous.

    Pools: (words, nblocks * block) rows of pack_scene, padded; block b
    holds primitives [b * block, (b + 1) * block). Box tables: (rows, 8)
    [min3, max3, start, count]; cluster rows of block b are
    [b * rows_per_block, (b + 1) * rows_per_block) with block-local
    primitive starts; super rows hold block-local (first cluster, count);
    ``bbox`` row 2b is block b's sphere union, 2b + 1 its triangle union.
    Rows that would be inverted (lo > hi: filler) are NaN."""

    sphf: torch.Tensor
    sphi: torch.Tensor
    trif: torch.Tensor
    trii: torch.Tensor
    sph_cl: torch.Tensor
    tri_cl: torch.Tensor
    sph_sup: torch.Tensor
    tri_sup: torch.Tensor
    bbox: torch.Tensor
    nblocks: int
    sph_blocks: int
    tri_blocks: int
    sph_leaf: int
    tri_leaf: int
    sc_rows: int
    tc_rows: int
    ss_rows: int
    ts_rows: int
    has_one_way: bool
    needs_tri_uv: bool

    @property
    def device(self) -> torch.device:
        return self.sphf.device


def _filler_rows(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_FILLER, dtype=torch.float32,
                        device=like.device).repeat(n, 1)


def _pad_pool(arr: torch.Tensor, block: int):
    total = max(block, -(-arr.shape[1] // block) * block)
    return torch.nn.functional.pad(arr, (0, total - arr.shape[1])), \
        total // block


def _leaf_boxes(pmin, pmax, leaf: int) -> torch.Tensor:
    """Per-leaf [lo, hi, 0, 0] rows from per-primitive bounds; masked
    primitives arrive inverted and vanish in the min / max."""
    n = pmin.shape[0]
    n_cl = -(-n // leaf)
    pad = n_cl * leaf - n
    if pad:
        pmin = torch.cat([pmin, torch.full((pad, 3), INF,
                                           device=pmin.device)])
        pmax = torch.cat([pmax, torch.full((pad, 3), -INF,
                                           device=pmax.device)])
    lo = pmin.reshape(n_cl, leaf, 3).amin(dim=1)
    hi = pmax.reshape(n_cl, leaf, 3).amax(dim=1)
    return torch.cat([lo, hi, torch.zeros((n_cl, 2), device=lo.device)],
                     dim=1)


def _nan_inverted(arr8: torch.Tensor) -> torch.Tensor:
    """NaN every inverted row: under the min/max slab test an inverted box
    is its swapped hull, always entered; NaN fails every compare."""
    return torch.where((arr8[:, 0] > arr8[:, 3])[:, None],
                       torch.full_like(arr8, math.nan), arr8)


def blocked_tables(scene) -> BlockedTables:
    """The blocked layout of ``_run_kernel_blocked``, value for value."""
    sphf, sphi, trif, trii, sphc, tric = pack_scene(scene)[:6]
    n_sph = int(scene.sph_center.shape[0])
    sph_leaf, tri_leaf = int(scene.sph_leaf), int(scene.tri_leaf)
    for leaf, block in ((sph_leaf, SPH_BLOCK), (tri_leaf, TRI_BLOCK)):
        rows = block // leaf
        if block % leaf or rows % min(SUP_GROUP, rows):
            # the JAX layout's reshapes need whole leaves and super groups
            # per block (leaf sizes 4, 8, 16, 32 give them)
            raise ValueError(f"blocked layout: leaf size {leaf} does not "
                             f"tile a {block}-primitive block")

    sphf, sb = _pad_pool(sphf, SPH_BLOCK)
    sphf = sphf.clone()
    sphf[S_CR2, n_sph:] = INF          # poison the padding spheres
    sphi, _ = _pad_pool(sphi, SPH_BLOCK)
    trif, tb = _pad_pool(trif, TRI_BLOCK)
    trii, _ = _pad_pool(trii, TRI_BLOCK)
    nblocks = max(sb, tb)

    # pools without a cluster table get synthesised per-leaf boxes, so the
    # block hierarchy can gate them
    s_n_cl = int(scene.sph_clusters.shape[0])
    if s_n_cl == 0 and n_sph > 0:
        ok = (scene.sph_radius > 0)[:, None]
        rad = scene.sph_radius[:, None]
        sphc = _leaf_boxes(
            torch.where(ok, scene.sph_center - rad, INF),
            torch.where(ok, scene.sph_center + rad, -INF), sph_leaf)
        s_n_cl = int(sphc.shape[0])
    n_tri = int(scene.tri_v0.shape[0])
    t_n_cl = int(scene.tri_clusters.shape[0])
    if t_n_cl == 0 and n_tri > 0:
        v0 = scene.tri_v0
        v1, v2 = v0 + scene.tri_e1, v0 + scene.tri_e2
        ok = scene.tri_valid[:, None]
        tric = _leaf_boxes(
            torch.where(ok, torch.minimum(torch.minimum(v0, v1), v2), INF),
            torch.where(ok, torch.maximum(torch.maximum(v0, v1), v2), -INF),
            tri_leaf)
        t_n_cl = int(tric.shape[0])

    def pad_clusters(cl, leaf, pool_slots, count, per_block):
        rows = max(pool_slots // leaf, nblocks * per_block)
        out = _filler_rows(rows, cl)
        if count > 0:
            out[:count] = cl[:count]
        return out

    sc_rows, tc_rows = SPH_BLOCK // sph_leaf, TRI_BLOCK // tri_leaf
    sphc = pad_clusters(sphc, sph_leaf, sphf.shape[1], s_n_cl, sc_rows)
    tric = pad_clusters(tric, tri_leaf, trif.shape[1], t_n_cl, tc_rows)

    # equalise the block axis across pools
    want_s = nblocks * SPH_BLOCK
    if sphf.shape[1] < want_s:
        padn = want_s - sphf.shape[1]
        sphf = torch.nn.functional.pad(sphf, (0, padn))
        sphf[S_CR2, -padn:] = INF
        sphi = torch.nn.functional.pad(sphi, (0, padn))
    want_t = nblocks * TRI_BLOCK
    if trif.shape[1] < want_t:
        trif = torch.nn.functional.pad(trif, (0, want_t - trif.shape[1]))
        trii = torch.nn.functional.pad(trii, (0, want_t - trii.shape[1]))

    def block_boxes(cl, rows_per_block):
        c = cl.reshape(nblocks, rows_per_block, 8)
        return torch.cat([c[:, :, 0:3].amin(dim=1), c[:, :, 3:6].amax(dim=1),
                          torch.zeros((nblocks, 2), device=cl.device)], dim=1)

    bbox = _nan_inverted(torch.stack(
        [block_boxes(sphc, sc_rows), block_boxes(tric, tc_rows)],
        dim=1).reshape(nblocks * 2, 8))

    def block_supers(cl, rows_per_block):
        grp = min(SUP_GROUP, rows_per_block)
        ns = rows_per_block // grp
        c = cl.reshape(nblocks, ns, grp, 8)
        start = (torch.arange(ns, device=cl.device, dtype=torch.float32)
                 * grp)[None, :, None].expand(nblocks, ns, 1)
        cnt = torch.full((nblocks, ns, 1), float(grp), device=cl.device)
        sup = torch.cat([c[..., 0:3].amin(dim=2), c[..., 3:6].amax(dim=2),
                         start, cnt], dim=-1)
        return sup.reshape(nblocks * ns, 8), ns

    sphs, ss_rows = block_supers(sphc, sc_rows)
    tris, ts_rows = block_supers(tric, tc_rows)
    return BlockedTables(
        sphf=sphf.contiguous(), sphi=sphi.contiguous(),
        trif=trif.contiguous(), trii=trii.contiguous(),
        sph_cl=_nan_inverted(sphc).contiguous(),
        tri_cl=_nan_inverted(tric).contiguous(),
        sph_sup=_nan_inverted(sphs).contiguous(),
        tri_sup=_nan_inverted(tris).contiguous(),
        bbox=bbox.contiguous(), nblocks=nblocks, sph_blocks=sb,
        tri_blocks=tb, sph_leaf=sph_leaf, tri_leaf=tri_leaf,
        sc_rows=sc_rows, tc_rows=tc_rows, ss_rows=ss_rows, ts_rows=ts_rows,
        has_one_way=bool(scene.has_one_way),
        needs_tri_uv=bool(scene.needs_tri_uv))


class WaveScene:
    """A scene packed once for the wavefront samplers: the SceneArrays
    (material and texture tables), and either the resident sweep pools
    (K5) or the blocked layout (K6). ``blocked=None`` routes by
    ``fits_smem``, as the JAX package does; True or False forces a route
    (the JAX package's RAYTRACER_FORCE_BLOCKED)."""

    def __init__(self, scene, blocked=None):
        self.scene = scene
        self.blocked = (not fits_smem(scene)) if blocked is None \
            else bool(blocked)
        self.packed = None if self.blocked else pack(scene)
        self.tables = blocked_tables(scene) if self.blocked else None

    @property
    def device(self) -> torch.device:
        return self.scene.device


# -- the plain versions -----------------------------------------------------

def _decode(out9):
    """(t, code, u, v, n0, n1, n2, pa, pb) -> the 12 outputs of K5:
    (t, code, u, v, n0, n1, n2, mat, col r, g, b, smooth)."""
    t, code, u, v, n0, n1, n2, pa, pb = out9
    colr, colg, colb = decode_colour30(pa)
    smooth, mat = decode_smooth_mat(pb)
    return [t, code, u, v, n0, n1, n2, mat, colr, colg, colb, smooth]


def _zero_misses(out9):
    """Miss lanes keep the sweep's zero carry (code, uv, params)."""
    hit = out9[0] < INF
    return [out9[0]] + [torch.where(hit, x, torch.zeros_like(x))
                        for x in out9[1:]]


def hit_resolve_reference(ps: PackedScene, o: torch.Tensor,
                          d: torch.Tensor):
    """Plain K5: nearest hit with exact triangle division, the winner's
    parameters decoded. o, d (3, N), unit d -> 12 (N,) tensors."""
    return _decode(_zero_misses(list(
        nearest_hit_reference(ps, o, d, fast_div=False))))


def _block_winner(bt: BlockedTables, b: int, o, d):
    """Brute-force nearest hit over block b: (t, code, u, v) with
    block-global codes."""
    s0, t0 = b * SPH_BLOCK, b * TRI_BLOCK
    t, code, u, v = _sweep_chunk(
        bt.sphf[:, s0:s0 + SPH_BLOCK], bt.trif[:, t0:t0 + TRI_BLOCK],
        bt.has_one_way, *(x[:, None] for x in (*o, *d)), fast_div=False)
    is_tri = (code & 1) == 1
    code = code + torch.where(is_tri, 2 * t0, 2 * s0).to(torch.int32)
    return t, code, u, v


def _blocked_params(bt: BlockedTables, t, code, bu, bv):
    """The winner's centre or normal, colour30, smooth|mat and texture UV
    from the blocked pools by global code; zero on a miss."""
    prim = (code >> 1).long()
    is_tri = (code & 1) == 1
    sp = torch.where(is_tri, 0, prim)
    tp = torch.where(is_tri, prim, 0)
    n = [torch.where(is_tri, bt.trif[T_NRM + c][tp], bt.sphf[c][sp])
         for c in range(3)]
    pa = torch.where(is_tri, bt.trii[0][tp], bt.sphi[0][sp])
    pb = torch.where(is_tri, bt.trii[1][tp], bt.sphi[1][sp])
    zero = torch.zeros_like(bu)
    if bt.needs_tri_uv:
        uv = [bt.trif[T_UV + c][tp] for c in range(6)]
        w = 1.0 - bu - bv
        u = torch.where(is_tri, uv[0] * w + uv[2] * bu + uv[4] * bv, zero)
        v = torch.where(is_tri, uv[1] * w + uv[3] * bu + uv[5] * bv, zero)
    else:
        u = v = zero
    return _zero_misses([t, code, u, v, *n, pa, pb])


def hit_resolve_blocked_reference(bt: BlockedTables, o: torch.Tensor,
                                  d: torch.Tensor):
    """Plain K6: every block brute-forced in index order, each block's
    winner (spheres before triangles, first index on ties) re-based to a
    global code and merged with a strict ``<``. o, d (3, N), unit d ->
    (t, code, u, v, n0, n1, n2, pa, pb), raw like JAX's K6."""
    n = o.shape[1]
    chunk = (1 << 23) // SPH_BLOCK
    parts = []
    for lo in range(0, n, chunk):
        oc, dc = o[:, lo:lo + chunk], d[:, lo:lo + chunk]
        best_t = torch.full((oc.shape[1],), INF, device=o.device)
        best = [torch.zeros(oc.shape[1], dtype=torch.int32, device=o.device),
                torch.zeros_like(best_t), torch.zeros_like(best_t)]
        for b in range(bt.nblocks):
            t, code, u, v = _block_winner(bt, b, oc, dc)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best = [torch.where(better, x, y)
                    for x, y in zip((code, u, v), best)]
        parts.append(_blocked_params(bt, best_t, *best))
    return tuple(torch.cat(p) for p in zip(*parts))


# -- the kernels ------------------------------------------------------------

def _outs(n, dev, dtypes):
    return [torch.empty(n, dtype=dt, device=dev) for dt in dtypes]


_F32, _I32 = torch.float32, torch.int32
_K5_DTYPES = (_F32, _I32, _F32, _F32, _F32, _F32, _F32, _I32, _F32, _F32,
              _F32, _F32)
_K6_DTYPES = (_F32, _I32, _F32, _F32, _F32, _F32, _F32, _I32, _I32)


def _hit_resolve_cuda(ps: PackedScene, o, d):
    from ..kernels import build
    outs = _outs(o.shape[1], o.device, _K5_DTYPES)
    args = build.ResolveArgs(
        scene=build.scene_args(ps), o=build.ptrs3(o), d=build.ptrs3(d),
        out=(ctypes.c_void_p * 12)(*[x.data_ptr() for x in outs]),
        n=o.shape[1])
    lib = build.load()
    rc = lib.rt_hit_resolve(ctypes.byref(args),
                            ctypes.c_void_p(build.stream(o.device)))
    build.check(lib, rc, "rt_hit_resolve")
    global LAUNCHES
    LAUNCHES += 1
    return outs


def _hit_resolve_blocked_cuda(bt: BlockedTables, o, d):
    from ..kernels import build
    outs = _outs(o.shape[1], o.device, _K6_DTYPES)
    args = build.BlockedArgs(
        *[x.data_ptr() for x in (bt.sphf, bt.sphi, bt.trif, bt.trii,
                                 bt.sph_cl, bt.tri_cl, bt.sph_sup,
                                 bt.tri_sup, bt.bbox)],
        bt.nblocks, bt.sph_blocks, bt.tri_blocks, bt.sph_leaf, bt.tri_leaf,
        bt.sc_rows, bt.tc_rows, bt.ss_rows, bt.ts_rows,
        int(bt.has_one_way), int(bt.needs_tri_uv),
        build.ptrs3(o), build.ptrs3(d),
        (ctypes.c_void_p * 9)(*[x.data_ptr() for x in outs]), o.shape[1])
    lib = build.load()
    rc = lib.rt_hit_resolve_blocked(ctypes.byref(args),
                                    ctypes.c_void_p(build.stream(o.device)))
    build.check(lib, rc, "rt_hit_resolve_blocked")
    global BLOCKED_LAUNCHES
    BLOCKED_LAUNCHES += 1
    return outs


def hit_resolve_unit(ws: WaveScene, o: torch.Tensor, d: torch.Tensor,
                     plain: bool = False):
    """K5 or K6 (by ``ws.blocked``) on rays with unit directions; the 12
    outputs of K5 (K6's pa/pb decoded after it). CPU tensors, or
    ``plain=True``, take the plain versions; CUDA tensors launch."""
    if o.device.type == "cpu" or plain:
        if ws.blocked:
            return _decode(hit_resolve_blocked_reference(ws.tables, o, d))
        return hit_resolve_reference(ws.packed, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"no hit kernel for device {o.device}")
    if ws.blocked:
        return _decode(_hit_resolve_blocked_cuda(ws.tables, o, d))
    return _hit_resolve_cuda(ws.packed, o, d)


def _run(ws: WaveScene, o: torch.Tensor, d: torch.Tensor, plain: bool):
    """``_run_kernel`` (intersect_pallas.py:728-837): pad to whole
    4096-ray tiles with o = 0, d = (1, 0, 0), normalise d with rsqrt, run
    K5 / K6, cut the padding and rescale t to the caller's directions."""
    _check_rays(o, d)
    if o.device != ws.device:
        raise ValueError(f"rays on {o.device}, scene on {ws.device}")
    n = o.shape[1]
    n_pad = max(RAY_TILE, -(-n // RAY_TILE) * RAY_TILE)
    if n_pad != n:
        pad_d = torch.zeros((3, n_pad - n), dtype=d.dtype, device=d.device)
        pad_d[0] = 1.0
        o = torch.cat([o, torch.zeros_like(pad_d)], dim=1)
        d = torch.cat([d, pad_d], dim=1)
    inv_len = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = (d * inv_len[None, :]).contiguous()
    outs = [x[:n] for x in hit_resolve_unit(ws, o.contiguous(), d, plain)]
    t = outs[0]
    outs[0] = torch.where(t < INF, t * inv_len[:n], INF)
    return outs


def nearest_hit(ws: WaveScene, o: torch.Tensor, d: torch.Tensor,
                plain: bool = False) -> HitRecord:
    """Nearest hit through K5 / K6 (``nearest_hit_pallas``); (3, N) rays."""
    t, code = _run(ws, o, d, plain)[:2]
    return HitRecord(t=t, hit=t < INF, is_tri=(code & 1) == 1,
                     idx=code >> 1)


def hit_and_resolve(ws: WaveScene, o: torch.Tensor, d: torch.Tensor,
                    need_sphere_uv: bool = True, plain: bool = False):
    """Fused nearest hit + shading resolve (``hit_and_resolve_pallas``,
    intersect_pallas.py:851-906): (HitRecord, ShadeData). The resolve is
    torch ops shared by the kernel and plain routes."""
    (t, code, u, v, n0, n1, n2, mat_id,
     colr, colg, colb, smooth) = _run(ws, o, d, plain)
    hit = t < INF
    is_tri = (code & 1) == 1
    rec = HitRecord(t=t, hit=hit, is_tri=is_tri, idx=code >> 1)

    safe_t = torch.where(hit, t, 0.0)
    point = o + d * safe_t[None, :]
    # sphere: n holds the centre; outward normal and lat/long UV
    # (src/objects.cu:66, 82-97)
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
    # triangle: n holds the geometric normal, flipped against the ray
    # (src/objects.cu:158)
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
