"""Scene construction: host builders -> structure-of-arrays tensors.

Every primitive is lowered at build time to one of two dense pools
(reference: src/objects.cu:801-916):

- spheres: centres, radii, material ids, denormalised colour/smoothness;
- triangles: vertices, edges, unit normals, per-vertex UVs, a one-way cull
  normal and a world->barycentric ("Woop") affine transform.

Quads, one-way quads, cuboids and meshes become triangles. The build is
numpy, the same arithmetic as ``raytracer_tpu.models.scene`` with the same
BVH builder (runtime/loader.py), and only the final step moves the arrays
to a torch device, so both packages start from identical primitives, BVH
leaf clusters, super-clusters, cell orders and image layout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.device import resolve_device
from .materials import MAT_REFRACTIVE, TEX_IMAGE, Material, compile_materials

_PAD = 8  # pad primitive pools to a multiple of this
_CLUSTER_LEAF = 32  # BVH leaf size for cluster culling
_SUPER_LEAF = 8     # clusters per super-cluster

# The newest ``SceneBuilder.build``: each pool's primitives, leaf size,
# clusters and supers, and the build's host ms. Always kept (one clock
# pair a build, no torch call); read by tests and scripts.
LAST_BUILD: dict = {}


def _super_level(clusters: np.ndarray, leaf: int) -> tuple:
    """Group leaf clusters under super-cluster AABBs (second BVH level).

    Returns (reordered_clusters, supers, order). ``order`` (or None) is the
    cluster permutation; the caller permutes the primitive pool in
    leaf-sized blocks to match, because cluster ``start`` columns are
    rewritten to ``index * leaf``.
    """
    c = clusters.shape[0]
    if c <= 2 * _SUPER_LEAF:
        return clusters, np.zeros((0, 8), np.float32), None
    from ..runtime.loader import build_bvh_clusters
    # fake triangles whose bounds equal the cluster boxes
    center = 0.5 * (clusters[:, :3] + clusters[:, 3:6])
    verts = np.stack([clusters[:, :3], clusters[:, 3:6], center], axis=1)
    order, bounds, meta = build_bvh_clusters(verts, _SUPER_LEAF)
    reordered = clusters[order].copy()
    reordered[:, 6] = np.arange(c, dtype=np.float32) * leaf
    supers = _leaf_clusters(bounds, meta)
    return reordered, supers, order


def _leaf_clusters(bounds: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """(num_nodes, 6) bounds + (num_nodes, 4) meta -> (C, 8) leaf rows,
    epsilon-padded so flat leaves survive the strict slab test."""
    leaf = meta[:, 0] == -1
    bmin = bounds[leaf, :3]
    bmax = bounds[leaf, 3:]
    pad = 1e-4 * np.maximum(np.linalg.norm(bmax - bmin, axis=1,
                                           keepdims=True), 1.0) + 1e-6
    return np.column_stack([
        bmin - pad,
        bmax + pad,
        meta[leaf, 2].astype(np.float32),
        meta[leaf, 3].astype(np.float32),
    ]).astype(np.float32)


def _cut_exact_leaves(pmin: np.ndarray, pmax: np.ndarray,
                      leaf: int) -> np.ndarray:
    """Cut the BVH-ordered primitive sequence into chunks of exactly
    ``leaf`` primitives -> (C, 8) cluster rows [min3, max3, start, count]."""
    n = pmin.shape[0]
    c = -(-n // leaf)
    big = np.full((c * leaf, 3), np.inf, np.float32)
    big[:n] = pmin
    small = np.full((c * leaf, 3), -np.inf, np.float32)
    small[:n] = pmax
    bmin = big.reshape(c, leaf, 3).min(axis=1)
    bmax = small.reshape(c, leaf, 3).max(axis=1)
    pad = 1e-4 * np.maximum(np.linalg.norm(bmax - bmin, axis=1,
                                           keepdims=True), 1.0) + 1e-6
    starts = (np.arange(c) * leaf).astype(np.float32)
    counts = np.minimum(n - np.arange(c) * leaf, leaf).astype(np.float32)
    return np.column_stack([bmin - pad, bmax + pad,
                            starts, counts]).astype(np.float32)


def _cell_order(clusters: np.ndarray, lo: np.ndarray,
                extent: np.ndarray, grid: int) -> np.ndarray:
    """Near-first cluster visitation order per coarse spatial cell:
    (grid^3 * C,) cluster ids sorted by distance from each cell centre."""
    bmin, bmax = clusters[:, :3], clusters[:, 3:6]
    idx = (np.arange(grid, dtype=np.float32) + 0.5) / grid
    centers = lo + np.stack(
        np.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3) * extent
    d = (np.maximum(bmin[None, :, :] - centers[:, None, :], 0.0)
         + np.maximum(centers[:, None, :] - bmax[None, :, :], 0.0))
    dist = np.linalg.norm(d, axis=-1)                     # (grid^3, C)
    return np.argsort(dist, axis=1, kind="stable").astype(
        np.int32).reshape(-1)


def _permute_leaf_blocks(arrs, n_slots: int, order: np.ndarray,
                         leaf: int) -> None:
    """Apply a cluster permutation to the primitive pool in place, moving
    whole leaf-sized blocks (keeps start == cluster_index * leaf)."""
    for arr in arrs:
        blocks = arr[:n_slots].reshape((len(order), leaf) + arr.shape[1:])
        arr[:n_slots] = blocks[order].reshape((n_slots,) + arr.shape[1:])


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Device-side scene: padded, static-shape SoA tensors.

    Field names and layouts are those of ``raytracer_tpu``'s SceneArrays,
    minus the lane-traversal tables, which the port does not use.
    """

    # Spheres (reference: src/objects.cu:25-98); radius <= 0 marks padding.
    sph_center: torch.Tensor   # (S, 3) f32
    sph_radius: torch.Tensor   # (S,) f32
    sph_mat: torch.Tensor      # (S,) i32
    sph_colour: torch.Tensor   # (S, 3) f32 const colour, 10-bit quantised
    sph_smooth: torch.Tensor   # (S,) f32, 8-bit quantised

    # Triangles (reference: src/objects.cu:101-200)
    tri_v0: torch.Tensor       # (T, 3) f32
    tri_e1: torch.Tensor       # (T, 3) f32  points[1] - points[0]
    tri_e2: torch.Tensor       # (T, 3) f32  points[2] - points[0]
    tri_normal: torch.Tensor   # (T, 3) f32 unit geometric normal
    tri_uv0: torch.Tensor      # (T, 2) f32 per-vertex texture coords
    tri_uv1: torch.Tensor      # (T, 2) f32
    tri_uv2: torch.Tensor      # (T, 2) f32
    tri_mat: torch.Tensor      # (T,) i32
    tri_valid: torch.Tensor    # (T,) bool; False marks padding/degenerate
    tri_cull: torch.Tensor     # (T, 3) f32 one-way normal (zero = two-sided)
    # Woop rows [row | -row.p0]: t = -(o.ww)/(d.ww), u = o.wu + t*d.wu, ...
    tri_wu: torch.Tensor       # (T, 4) f32
    tri_wv: torch.Tensor       # (T, 4) f32
    tri_ww: torch.Tensor       # (T, 4) f32
    tri_colour: torch.Tensor   # (T, 3) f32
    tri_smooth: torch.Tensor   # (T,) f32

    # Material table (reference: src/material.cu:128-186)
    mat_type: torch.Tensor     # (M,) i32
    mat_smooth: torch.Tensor   # (M,) f32
    mat_ior: torch.Tensor      # (M,) f32
    mat_emit: torch.Tensor     # (M, 3) f32

    # Texture table + atlas (reference: src/material.cu:4-125)
    tex_type: torch.Tensor     # (M,) i32
    tex_colour: torch.Tensor   # (M, 3) f32
    tex_light: torch.Tensor    # (M, 3) f32
    tex_dark: torch.Tensor     # (M, 3) f32
    tex_nsq: torch.Tensor      # (M,) f32
    tex_offset: torch.Tensor   # (M,) i32
    tex_width: torch.Tensor    # (M,) i32
    tex_height: torch.Tensor   # (M,) i32
    atlas: torch.Tensor        # (P, 3) f32 texels, 10-bit quantised
    tex_row: torch.Tensor      # (M,) i32 first row of the image in the
    #                            packed texel plane (0 for non-image)

    # BVH leaf clusters [min3, max3, start, count] (C, 8) f32; C == 0
    # disables culling for the pool. Supers group contiguous cluster
    # ranges the same way. Cell orders: (grid^3 * C,) i32 or (1,).
    tri_clusters: torch.Tensor
    sph_clusters: torch.Tensor
    tri_supers: torch.Tensor
    sph_supers: torch.Tensor
    sph_cell_order: torch.Tensor
    tri_cell_order: torch.Tensor
    cell_grid: torch.Tensor    # (6,) f32 [lo(3), grid/extent(3)]

    # Static metadata. ``img_layout`` holds (atlas offset, height, width,
    # first packed row) per distinct image; an image w texels wide takes
    # h * ceil(w / 128) rows of the (img_rows, 128) texel plane
    # (megakernel.pack_textures); img_rows == 0 means no image texture.
    needs_sphere_uv: bool = True
    has_image_tex: bool = False
    has_one_way: bool = True
    has_refractive: bool = True
    needs_tri_uv: bool = True
    sph_leaf: int = 32
    tri_leaf: int = 32
    img_layout: tuple = ()
    img_rows: int = 0

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    def to(self, device) -> "SceneArrays":
        """Copy of the scene with every tensor on ``device``."""
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _prim_params(mat: Material) -> Tuple:
    """(colour3, smoothness) denormalised onto the primitive, quantised to
    the kernels' packing precision (10-bit colour, 8-bit smoothness)."""
    from ..ops.sweep import quantise_colour, quantise_smooth
    colour = mat.texture.colour if mat.texture.type == 0 else (1.0, 1.0, 1.0)
    return (tuple(float(c) for c in quantise_colour(colour)),
            float(quantise_smooth(mat.smoothness)))


@dataclasses.dataclass
class _TriRecord:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    uv: Optional[Tuple] = None            # ((u,v) per vertex) or None
    cull: Optional[np.ndarray] = None     # one-way cull normal or None
    mat_id: int = 0
    params: Tuple = ((1.0, 1.0, 1.0), 0.0)


class SceneBuilder:
    """Collects primitives, then builds the SoA tensors.

    API mirrors the reference's ``Object::create_*`` factories
    (src/objects.cu:845-906) plus the composed shapes and meshes.
    """

    def __init__(self):
        self._spheres: List[Tuple] = []
        self._bulk_spheres: List[Tuple] = []  # add_spheres chunks
        self._tris: List[_TriRecord] = []
        self._materials: List[Material] = []
        self._mat_index: dict = {}
        self.use_sky: bool = True
        # (first, end) triangle index of each mesh, in add order
        self.mesh_ranges: List[Tuple[int, int]] = []

    def material_id(self, mat: Material) -> int:
        """Intern the material's behaviour (everything but the colour and
        smoothness, which are denormalised onto the primitives)."""
        key = self._behaviour(mat)
        if key not in self._mat_index:
            self._mat_index[key] = len(self._materials)
            self._materials.append(key)
        return self._mat_index[key]

    @staticmethod
    def _behaviour(mat: Material) -> Material:
        tex = mat.texture
        if tex.type == 0:  # const colour lives on the primitive
            tex = dataclasses.replace(tex, colour=(0.0, 0.0, 0.0))
        return dataclasses.replace(mat, texture=tex, smoothness=0.0)

    def add_sphere(self, center, radius: float, mat: Material) -> None:
        self._spheres.append(
            (np.asarray(center, np.float32), float(radius),
             self.material_id(mat), _prim_params(mat)))

    def add_spheres(self, centers, radii, mat: Material, colours=None,
                    smooth=None) -> None:
        """Vectorised bulk add: N spheres sharing one material behaviour.

        ``colours`` ((N, 3)) and ``smooth`` ((N,) or scalar) override the
        material's per-primitive albedo and smoothness, as N materials that
        differ only in those would (they intern to one behaviour row). A
        per-sphere Python loop costs about 1 s per 10k spheres; this builds
        100k in milliseconds.
        """
        from ..ops.sweep import quantise_colour, quantise_smooth
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        n = centers.shape[0]
        radii = np.broadcast_to(
            np.asarray(radii, np.float32), (n,)).astype(np.float32)
        mid = self.material_id(mat)
        base_col, base_sm = _prim_params(mat)
        if colours is not None and mat.texture.type == 0:
            col = quantise_colour(
                np.asarray(colours, np.float32).reshape(n, 3))
        else:
            col = np.broadcast_to(np.asarray(base_col, np.float32), (n, 3))
        sm = np.broadcast_to(np.asarray(
            base_sm if smooth is None else quantise_smooth(smooth),
            np.float32), (n,))
        self._bulk_spheres.append(
            (centers, radii, np.full(n, mid, np.int32),
             np.ascontiguousarray(col, np.float32),
             np.ascontiguousarray(sm, np.float32)))

    def add_triangle(self, p0, p1, p2, mat: Material, uvs=None,
                     cull: Optional[np.ndarray] = None) -> None:
        self._tris.append(_TriRecord(
            v0=np.asarray(p0, np.float32),
            v1=np.asarray(p1, np.float32),
            v2=np.asarray(p2, np.float32),
            uv=uvs, cull=cull, mat_id=self.material_id(mat),
            params=_prim_params(mat)))

    def add_quad(self, p1, p2, p3, p4, mat: Material,
                 cull: Optional[np.ndarray] = None) -> None:
        """Two triangles with the reference's fixed corner UVs
        (src/objects.cu:244-253): t1=(p1,p2,p3), t2=(p1,p4,p3)."""
        uv1, uv2, uv3, uv4 = (0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)
        self.add_triangle(p1, p2, p3, mat, uvs=(uv1, uv2, uv3), cull=cull)
        self.add_triangle(p1, p4, p3, mat, uvs=(uv1, uv4, uv3), cull=cull)

    def add_one_way_quad(self, p1, p2, p3, p4, invert_normal: bool,
                         mat: Material) -> None:
        """Quad whose hits require dot(ray_dir, normal) >= 0
        (src/objects.cu:257-290). Both triangles cull against t1's normal."""
        p1a = np.asarray(p1, np.float32)
        e1 = np.asarray(p2, np.float32) - p1a
        e2 = np.asarray(p3, np.float32) - p1a
        n = np.cross(e1, e2)
        n = n / np.linalg.norm(n)
        if invert_normal:
            n = -n
        self.add_quad(p1, p2, p3, p4, mat, cull=n.astype(np.float32))

    def add_cuboid(self, tl_near, width: float, height: float, depth: float,
                   mat: Material) -> None:
        """Six quads from the top-left-near corner (src/objects.cu:327-349)."""
        tl_near = np.asarray(tl_near, np.float32)
        w = np.array([width, 0, 0], np.float32)
        h = np.array([0, height, 0], np.float32)
        d = np.array([0, 0, depth], np.float32)

        tr_near = tl_near + w
        br_near = tr_near - h
        bl_near = tl_near - h
        tl_far = tl_near + d
        tr_far = tl_far + w
        br_far = tr_far - h
        bl_far = tl_far - h

        self.add_quad(tl_near, tr_near, br_near, bl_near, mat)  # front
        self.add_quad(tl_far, tr_far, br_far, bl_far, mat)      # back
        self.add_quad(tl_near, bl_near, bl_far, tl_far, mat)    # left
        self.add_quad(tr_near, br_near, br_far, tr_far, mat)    # right
        self.add_quad(bl_near, br_near, br_far, bl_far, mat)    # bottom
        self.add_quad(tl_near, tr_near, tr_far, tl_far, mat)    # top

    def add_mesh(self, faces: Sequence[np.ndarray], mat: Material) -> int:
        """Add a triangle/quad-faced mesh (the OBJ path, src/main.cu:127-148).

        ``faces`` is a sequence of (3, 3) or (4, 3) float arrays; quads
        become two triangles with the quad corner UVs. Every face shades
        with the mesh's material, as in the reference (quirk #7,
        src/raytracer.cu:41). Returns the mesh id.
        """
        mesh_id = len(self.mesh_ranges)
        start = len(self._tris)
        for face in faces:
            face = np.asarray(face, np.float32)
            if face.shape[0] == 3:
                self.add_triangle(face[0], face[1], face[2], mat)
            elif face.shape[0] == 4:
                self.add_quad(face[0], face[1], face[2], face[3], mat)
            else:
                raise ValueError(
                    "Only triangle or quad mesh faces are supported.")
        self.mesh_ranges.append((start, len(self._tris)))
        return mesh_id

    def build(self, device="cuda") -> SceneArrays:
        """The scene's arrays on ``device`` (the card by default; raises
        without one, utils/device.py). Span ``scene.build``, with the
        children ``scene.woop`` (the per-triangle transforms) and
        ``scene.bvh`` (both BVH levels of both pools); the pools'
        hierarchy and the host ms go to ``LAST_BUILD``."""
        device = resolve_device(device)
        t0 = time.perf_counter()
        with trace.span("scene.build"):
            scene = self._build(device)
        LAST_BUILD.clear()
        LAST_BUILD.update(
            spheres=len(self._spheres)
            + sum(c.shape[0] for c, *_ in self._bulk_spheres),
            triangles=len(self._tris),
            sph_leaf=scene.sph_leaf, tri_leaf=scene.tri_leaf,
            sph_clusters=int(scene.sph_clusters.shape[0]),
            tri_clusters=int(scene.tri_clusters.shape[0]),
            sph_supers=int(scene.sph_supers.shape[0]),
            tri_supers=int(scene.tri_supers.shape[0]),
            host_ms=1e3 * (time.perf_counter() - t0))
        return scene

    def _build(self, device) -> SceneArrays:
        if not self._materials:
            self.material_id(Material.default())

        from ..ops.sweep import UNROLL, leaf_size
        bulk_n = sum(c.shape[0] for c, *_ in self._bulk_spheres)
        s = len(self._spheres) + bulk_n
        t = len(self._tris)
        # Clustered pools are padded to whole BVH leaves; padding
        # primitives are poisoned at pack time.
        s_clustered = s > 2 * _CLUSTER_LEAF
        t_clustered = t > 2 * _CLUSTER_LEAF
        s_leaf = leaf_size(s) if s_clustered else _CLUSTER_LEAF
        t_leaf = leaf_size(t) if t_clustered else _CLUSTER_LEAF
        s_pad = _round_up(s, s_leaf if s_clustered else max(_PAD, UNROLL))
        t_pad = _round_up(t, t_leaf if t_clustered else max(_PAD, UNROLL))

        sph_center = np.zeros((s_pad, 3), np.float32)
        sph_radius = np.zeros(s_pad, np.float32)  # pad radius 0 => never hits
        sph_mat = np.zeros(s_pad, np.int32)
        sph_colour = np.ones((s_pad, 3), np.float32)
        sph_smooth = np.zeros(s_pad, np.float32)
        for i, (c, r, m, (col, sm)) in enumerate(self._spheres):
            sph_center[i] = c
            sph_radius[i] = r
            sph_mat[i] = m
            sph_colour[i] = col
            sph_smooth[i] = sm
        i0 = len(self._spheres)
        for (c, r, m, col, sm) in self._bulk_spheres:
            k = c.shape[0]
            sph_center[i0:i0 + k] = c
            sph_radius[i0:i0 + k] = r
            sph_mat[i0:i0 + k] = m
            sph_colour[i0:i0 + k] = col
            sph_smooth[i0:i0 + k] = sm
            i0 += k

        tri_v0 = np.zeros((t_pad, 3), np.float32)
        tri_e1 = np.zeros((t_pad, 3), np.float32)
        tri_e2 = np.zeros((t_pad, 3), np.float32)
        tri_normal = np.zeros((t_pad, 3), np.float32)
        tri_uv = np.zeros((3, t_pad, 2), np.float32)
        tri_mat = np.zeros(t_pad, np.int32)
        tri_colour = np.ones((t_pad, 3), np.float32)
        tri_smooth = np.zeros(t_pad, np.float32)
        tri_valid = np.zeros(t_pad, bool)
        tri_cull = np.zeros((t_pad, 3), np.float32)
        tri_w = np.zeros((3, t_pad, 4), np.float32)

        with trace.span("scene.woop"):
            for i, rec in enumerate(self._tris):
                e1 = rec.v1 - rec.v0
                e2 = rec.v2 - rec.v0
                n = np.cross(e1, e2)
                n_len = np.linalg.norm(n)
                tri_v0[i] = rec.v0
                tri_e1[i] = e1
                tri_e2[i] = e2
                tri_mat[i] = rec.mat_id
                tri_colour[i], tri_smooth[i] = rec.params
                if rec.uv is not None:
                    tri_uv[0, i] = rec.uv[0]
                    tri_uv[1, i] = rec.uv[1]
                    tri_uv[2, i] = rec.uv[2]
                if rec.cull is not None:
                    tri_cull[i] = rec.cull
                if n_len <= 0.0 or not np.isfinite(n_len):
                    # degenerate: left invalid, its zero Woop rows never hit
                    continue
                tri_normal[i] = (n / n_len).astype(np.float32)
                tri_valid[i] = True
                # Woop world->barycentric transform: solve
                # [e1 e2 n] x = p - v0.
                w_mat = np.stack([e1, e2, n / n_len],
                                 axis=1).astype(np.float64)
                try:
                    inv = np.linalg.inv(w_mat)
                except np.linalg.LinAlgError:
                    tri_valid[i] = False
                    tri_normal[i] = 0.0
                    continue
                for row in range(3):
                    tri_w[row, i, :3] = inv[row]
                    tri_w[row, i, 3] = -inv[row] @ rec.v0.astype(np.float64)

        # --- BVH leaf clustering (reference BVH, src/objects.cu:448-771,
        # cut into leaves of exactly the pool's leaf size) ---
        with trace.span("scene.bvh"):
            tri_clusters = np.zeros((0, 8), np.float32)
            sph_clusters = np.zeros((0, 8), np.float32)
            tri_supers = np.zeros((0, 8), np.float32)
            sph_supers = np.zeros((0, 8), np.float32)
            if t_clustered:
                from ..runtime.loader import build_bvh_clusters
                verts = np.stack([tri_v0[:t], tri_v0[:t] + tri_e1[:t],
                                  tri_v0[:t] + tri_e2[:t]], axis=1)
                order, _, _ = build_bvh_clusters(verts, _CLUSTER_LEAF)
                tri_arrs = [tri_v0, tri_e1, tri_e2, tri_normal, tri_mat,
                            tri_valid, tri_cull, tri_colour, tri_smooth]
                for arr in tri_arrs:
                    arr[:t] = arr[:t][order]
                for k in range(3):
                    tri_uv[k, :t] = tri_uv[k, :t][order]
                    tri_w[k, :t] = tri_w[k, :t][order]
                pmin = np.minimum(np.minimum(verts[order, 0], verts[order, 1]),
                                  verts[order, 2])
                pmax = np.maximum(np.maximum(verts[order, 0], verts[order, 1]),
                                  verts[order, 2])
                tri_clusters = _cut_exact_leaves(pmin, pmax, t_leaf)
                tri_clusters, tri_supers, corder = _super_level(tri_clusters,
                                                                t_leaf)
                if corder is not None:
                    _permute_leaf_blocks(
                        tri_arrs + [tri_uv[0], tri_uv[1], tri_uv[2],
                                    tri_w[0], tri_w[1], tri_w[2]],
                        t_pad, corder, t_leaf)
            if s_clustered:
                from ..runtime.loader import build_bvh_clusters
                c = sph_center[:s]
                r = sph_radius[:s, None]
                # spheres as degenerate triangles: bounds = center +- r
                verts = np.stack([c - r, c + r, c], axis=1)
                order, _, _ = build_bvh_clusters(verts, _CLUSTER_LEAF)
                sph_arrs = [sph_center, sph_radius, sph_mat, sph_colour,
                            sph_smooth]
                for arr in sph_arrs:
                    arr[:s] = arr[:s][order]
                pmin = (sph_center[:s] - sph_radius[:s, None])
                pmax = (sph_center[:s] + sph_radius[:s, None])
                sph_clusters = _cut_exact_leaves(pmin, pmax, s_leaf)
                sph_clusters, sph_supers, corder = _super_level(sph_clusters,
                                                                s_leaf)
                if corder is not None:
                    _permute_leaf_blocks(sph_arrs, s_pad, corder, s_leaf)

        # --- per-cell near-first visitation orders (8..512 top-level boxes)
        grid_n = 4
        sph_cell_order = np.zeros((1,), np.int32)
        tri_cell_order = np.zeros((1,), np.int32)
        cell_grid = np.zeros((6,), np.float32)
        boxes = [c for c in (sph_clusters, tri_clusters) if c.shape[0] > 0]
        if boxes:
            all_b = np.concatenate(boxes, axis=0)
            lo = all_b[:, :3].min(axis=0)
            extent = np.maximum(all_b[:, 3:6].max(axis=0) - lo, 1e-6)
            cell_grid = np.concatenate(
                [lo, grid_n / extent]).astype(np.float32)

            def order_for(clusters, supers):
                top = supers if supers.shape[0] > 0 else clusters
                if 8 <= top.shape[0] <= 512:
                    return _cell_order(top, lo, extent, grid_n)
                return np.zeros((1,), np.int32)

            sph_cell_order = order_for(sph_clusters, sph_supers)
            tri_cell_order = order_for(tri_clusters, tri_supers)

        table = compile_materials(self._materials)

        # --- image layout: each distinct image gets a band of rows of the
        # (img_rows, 128) texel plane; tex_row is its first row ---
        img_layout = []
        img_rows = 0
        tex_row = np.zeros(table.tex_type.shape[0], np.int32)
        seen_off = {}
        for m in range(table.tex_type.shape[0]):
            if table.tex_type[m] != TEX_IMAGE:
                continue
            off = int(table.tex_offset[m])
            h, w = int(table.tex_height[m]), int(table.tex_width[m])
            if off not in seen_off:
                seen_off[off] = img_rows
                img_layout.append((off, h, w, img_rows))
                img_rows += h * (-(-w // 128))
            tex_row[m] = seen_off[off]

        needs_sphere_uv = bool(
            np.any(table.tex_type[sph_mat[:s]] != 0)) if s > 0 else False
        needs_tri_uv = bool(
            np.any(table.tex_type[tri_mat[:t]] != 0)) if t > 0 else False
        has_one_way = bool(np.any(tri_cull[:t] != 0)) if t > 0 else False

        def dev(a):
            return torch.as_tensor(a, device=device)

        return SceneArrays(
            tri_clusters=dev(tri_clusters),
            sph_clusters=dev(sph_clusters),
            tri_supers=dev(tri_supers),
            sph_supers=dev(sph_supers),
            sph_cell_order=dev(sph_cell_order),
            tri_cell_order=dev(tri_cell_order),
            cell_grid=dev(cell_grid),
            needs_sphere_uv=needs_sphere_uv,
            has_image_tex=bool(np.any(table.tex_type == TEX_IMAGE)),
            has_one_way=has_one_way,
            has_refractive=bool(np.any(table.mat_type == MAT_REFRACTIVE)),
            needs_tri_uv=needs_tri_uv,
            sph_leaf=int(s_leaf),
            tri_leaf=int(t_leaf),
            img_layout=tuple(img_layout),
            img_rows=int(img_rows),
            sph_center=dev(sph_center),
            sph_radius=dev(sph_radius),
            sph_mat=dev(sph_mat),
            sph_colour=dev(sph_colour),
            sph_smooth=dev(sph_smooth),
            tri_v0=dev(tri_v0),
            tri_e1=dev(tri_e1),
            tri_e2=dev(tri_e2),
            tri_normal=dev(tri_normal),
            tri_uv0=dev(tri_uv[0]),
            tri_uv1=dev(tri_uv[1]),
            tri_uv2=dev(tri_uv[2]),
            tri_mat=dev(tri_mat),
            tri_valid=dev(tri_valid),
            tri_cull=dev(tri_cull),
            tri_wu=dev(tri_w[0]),
            tri_wv=dev(tri_w[1]),
            tri_ww=dev(tri_w[2]),
            tri_colour=dev(tri_colour),
            tri_smooth=dev(tri_smooth),
            mat_type=dev(table.mat_type),
            mat_smooth=dev(table.smoothness),
            mat_ior=dev(table.ior),
            mat_emit=dev(table.emitted),
            tex_type=dev(table.tex_type),
            tex_colour=dev(table.tex_colour),
            tex_light=dev(table.tex_light),
            tex_dark=dev(table.tex_dark),
            tex_nsq=dev(table.tex_nsq),
            tex_offset=dev(table.tex_offset),
            tex_width=dev(table.tex_width),
            tex_height=dev(table.tex_height),
            atlas=dev(table.atlas),
            tex_row=dev(tex_row),
        )
