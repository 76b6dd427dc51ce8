"""Scene primitives as the renderer intersects them: spheres and
triangles with their materials denormalised onto each primitive.

Colours are quantised to 10 bits a channel and smoothness to 8 bits, as
the renderer stores them; triangles carry the Woop world-to-barycentric
rows. Spheres are ordered as the renderer's median-split BVH orders them
(leaves of 32), because an exact tie in t goes to the lower index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

TEX_COLOUR, TEX_GRADIENT, TEX_CHECKER, TEX_IMAGE = 0, 1, 2, 3
MAT_STANDARD, MAT_EMISSIVE, MAT_REFRACTIVE = 0, 1, 2
CLUSTER = 32       # primitives per BVH leaf the order is cut from


def material(kind: str = "standard", colour=(1.0, 1.0, 1.0),
             smoothness: float = 0.0, checker=None, image=None,
             emit=(0.0, 0.0, 0.0), ior: float = 1.0) -> dict:
    """A material: ``kind`` standard / emissive / refractive; the texture
    is a constant ``colour``, a ``checker`` (light, dark, squares) or an
    ``image`` (H, W, 3). Refractive materials are mirror-smooth; an
    emissive one carries colour * strength in ``emit``."""
    if kind == "refractive":
        smoothness = 1.0
    tex = TEX_COLOUR
    if checker is not None:
        tex = TEX_CHECKER
    elif image is not None:
        tex = TEX_IMAGE
    return dict(kind={"standard": MAT_STANDARD, "emissive": MAT_EMISSIVE,
                      "refractive": MAT_REFRACTIVE}[kind],
                colour=colour if tex == TEX_COLOUR else (1.0, 1.0, 1.0),
                smoothness=smoothness, tex=tex, checker=checker,
                image=image, emit=emit, ior=ior)


def _q(values, levels: int) -> np.ndarray:
    """Round to ``levels`` steps on [0, 1], as float32."""
    return np.round(np.clip(np.asarray(values, np.float32), 0.0, 1.0)
                    * np.float32(levels))


@dataclasses.dataclass
class Scene:
    """Per-primitive tensors, spheres then triangles, on one device."""

    sph: torch.Tensor      # (S, 4): centre, radius
    tri_w: torch.Tensor    # (T, 12): Woop u, v, w rows [r | -r.p0]
    tri_n: torch.Tensor    # (T, 3) unit normal
    tri_cull: torch.Tensor  # (T, 3) one-way normal, zero = two-sided
    tri_uv: torch.Tensor   # (T, 6) uv0, uv1, uv2
    # per primitive, spheres first: colour (3), smoothness, kind, ior,
    # emit (3), texture type, light (3), dark (3), squares
    prim: torch.Tensor     # (S + T, 17) float32
    image: Optional[torch.Tensor]   # (H, W, 3) texels or None
    need_sphere_uv: bool
    needs_tri_uv: bool
    has_one_way: bool
    has_refractive: bool

    @property
    def n_sph(self) -> int:
        return self.sph.shape[0]

    def to(self, device, dtype=torch.float32) -> "Scene":
        def cast(x):
            return None if x is None else x.to(device=device, dtype=dtype)
        return dataclasses.replace(
            self, sph=cast(self.sph), tri_w=cast(self.tri_w),
            tri_n=cast(self.tri_n), tri_cull=cast(self.tri_cull),
            tri_uv=cast(self.tri_uv), prim=cast(self.prim),
            image=cast(self.image))


def _bvh_order(lo: np.ndarray, hi: np.ndarray, cen: np.ndarray,
               leaf: int) -> list:
    """Leaf order of a median-split BVH over boxes (lo, hi) and
    centroids: the longest axis of each node's box, split at the median
    centroid, or in halves of the sorted order when the median splits
    nothing off."""
    order: list = []

    def build(idx: np.ndarray) -> None:
        if len(idx) <= leaf:
            order.extend(int(i) for i in idx)
            return
        bmin, bmax = lo[idx].min(axis=0), hi[idx].max(axis=0)
        axis = int(np.argmax(bmax - bmin))
        med = np.median(cen[idx, axis])
        left = cen[idx, axis] <= med
        if left.all() or not left.any():
            half = len(idx) // 2
            s = idx[np.argsort(cen[idx, axis], kind="stable")]
            build(s[:half])
            build(s[half:])
        else:
            build(idx[left])
            build(idx[~left])

    build(np.arange(lo.shape[0]))
    return order


class Builder:
    """Collects spheres and triangles with their materials."""

    def __init__(self):
        self.spheres: list = []
        self.tris: list = []

    def sphere(self, centre, radius: float, mat: dict) -> None:
        self.spheres.append((np.asarray(centre, np.float32), float(radius),
                             mat))

    def triangle(self, p0, p1, p2, mat: dict, uvs=None, cull=None) -> None:
        self.tris.append(tuple(np.asarray(p, np.float32)
                               for p in (p0, p1, p2)) + (mat, uvs, cull))

    def quad(self, p1, p2, p3, p4, mat: dict, cull=None) -> None:
        """Triangles (p1, p2, p3) and (p1, p4, p3) with the corner UVs."""
        self.triangle(p1, p2, p3, mat, ((0, 0), (1, 0), (1, 1)), cull)
        self.triangle(p1, p4, p3, mat, ((0, 0), (0, 1), (1, 1)), cull)

    def one_way_quad(self, p1, p2, p3, p4, mat: dict) -> None:
        """A quad hit only by rays along its first triangle's normal."""
        p1a = np.asarray(p1, np.float32)
        n = np.cross(np.asarray(p2, np.float32) - p1a,
                     np.asarray(p3, np.float32) - p1a)
        self.quad(p1, p2, p3, p4, mat, (n / np.linalg.norm(n)).astype(
            np.float32))

    def cuboid(self, tl_near, width, height, depth, mat: dict) -> None:
        """Six quads from the top-left-near corner."""
        tl = np.asarray(tl_near, np.float32)
        w = np.array([width, 0, 0], np.float32)
        h = np.array([0, height, 0], np.float32)
        d = np.array([0, 0, depth], np.float32)
        tr, bl = tl + w, tl - h
        br = tr - h
        tlf, trf = tl + d, tl + d + w
        brf, blf = trf - h, tlf - h
        for q in ((tl, tr, br, bl), (tlf, trf, brf, blf),
                  (tl, bl, blf, tlf), (tr, br, brf, trf),
                  (bl, br, brf, blf), (tl, tr, trf, tlf)):
            self.quad(*q, mat)

    def build(self, device="cpu") -> Scene:
        order = list(range(len(self.spheres)))
        if len(self.spheres) > 2 * CLUSTER:
            c = np.stack([s[0] for s in self.spheres])
            r = np.array([s[1] for s in self.spheres], np.float32)[:, None]
            verts = np.stack([c - r, c + r, c], axis=1)
            order = _bvh_order(verts.min(axis=1), verts.max(axis=1),
                               verts.mean(axis=1), CLUSTER)
            leaves = -(-len(order) // _leaf_size(len(order)))
            if leaves > 16:
                raise NotImplementedError(
                    "a second BVH level reorders the leaves; this "
                    "reference orders one level only")
        spheres = [self.spheres[i] for i in order]
        sph = np.zeros((len(spheres), 4), np.float32)
        for i, (c, r, _) in enumerate(spheres):
            sph[i, :3], sph[i, 3] = c, r
        t = len(self.tris)
        tri_w = np.zeros((t, 12), np.float32)
        tri_n = np.zeros((t, 3), np.float32)
        tri_cull = np.zeros((t, 3), np.float32)
        tri_uv = np.zeros((t, 6), np.float32)
        for i, (v0, v1, v2, _, uvs, cull) in enumerate(self.tris):
            e1, e2 = v1 - v0, v2 - v0
            n = np.cross(e1, e2)
            n_len = np.linalg.norm(n)
            if uvs is not None:
                tri_uv[i] = np.asarray(uvs, np.float32).reshape(6)
            if cull is not None:
                tri_cull[i] = cull
            if n_len <= 0.0 or not np.isfinite(n_len):
                continue
            tri_n[i] = (n / n_len).astype(np.float32)
            inv = np.linalg.inv(np.stack([e1, e2, n / n_len], axis=1)
                                .astype(np.float64))
            for row in range(3):
                tri_w[i, 4 * row:4 * row + 3] = inv[row]
                tri_w[i, 4 * row + 3] = -inv[row] @ v0.astype(np.float64)
        mats = [s[2] for s in spheres] + [tr[3] for tr in self.tris]
        prim = np.zeros((len(mats), 17), np.float32)
        image = None
        for i, m in enumerate(mats):
            prim[i, 0:3] = _q(m["colour"], 1023) * np.float32(1.0 / 1023.0)
            prim[i, 3] = _q(m["smoothness"], 255) * np.float32(1.0 / 255.0)
            prim[i, 4] = m["kind"]
            prim[i, 5] = m["ior"]
            prim[i, 6:9] = m["emit"]
            prim[i, 9] = m["tex"]
            if m["checker"] is not None:
                light, dark, squares = m["checker"]
                prim[i, 10:13], prim[i, 13:16] = light, dark
                prim[i, 16] = squares
            if m["image"] is not None:
                image = (_q(m["image"], 1023) * np.float32(1.0 / 1023.0))
        tex_sph = [m["tex"] for m in mats[:len(spheres)]]
        tex_tri = [m["tex"] for m in mats[len(spheres):]]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return Scene(
            sph=dev(sph), tri_w=dev(tri_w), tri_n=dev(tri_n),
            tri_cull=dev(tri_cull), tri_uv=dev(tri_uv), prim=dev(prim),
            image=None if image is None else dev(image.astype(np.float32)),
            need_sphere_uv=any(x != TEX_COLOUR for x in tex_sph),
            needs_tri_uv=any(x != TEX_COLOUR for x in tex_tri),
            has_one_way=bool(np.any(tri_cull != 0)),
            has_refractive=any(m["kind"] == MAT_REFRACTIVE for m in mats))


def _leaf_size(n: int) -> int:
    leaves = -(-n // CLUSTER)
    per = -(-n // leaves)
    return -(-per // 4) * 4
