"""Plain reference scene of ``spd_tetra6``: Haines' SPD recursive
tetrahedral pyramid (``tetra.c``) at level 6, 16,384 triangles of one
diffuse material under the sky.

The triangles are given to the Builder in the order the renderer's
numpy BVH arm leaves them, because an exact tie in t goes to the lower
index: a median split over the triangles (leaves of 32), the sequence
cut into leaves of exactly 32, then the same split over those leaves'
boxes (leaves of 8), which moves whole leaves. The renderer's native
arm (``std::nth_element``) orders leaves otherwise; that only decides
exact ties.
"""

from __future__ import annotations

import numpy as np

from pbref.scene import Builder, _bvh_order, material

FACES = ((0, 1, 2), (0, 2, 3), (0, 3, 1), (1, 3, 2))   # apex first


def faces(level: int, centroid) -> np.ndarray:
    """(4 * 4^level, 3, 3) float32: a regular tetrahedron of circumradius
    1, apex up, replaced ``level`` times by its four half-size corner
    copies (corner i of T is (T + T[i]) / 2), each as its four faces."""
    base = np.array([[0.0, 1.0, 0.0],
                     [0.0, -1.0 / 3.0, -np.sqrt(8.0 / 9.0)],
                     [np.sqrt(2.0 / 3.0), -1.0 / 3.0, np.sqrt(2.0) / 3.0],
                     [-np.sqrt(2.0 / 3.0), -1.0 / 3.0, np.sqrt(2.0) / 3.0]])
    tets = (base + np.asarray(centroid, np.float64))[None]
    for _ in range(level):
        tets = ((tets[:, None, :, :] + tets[:, :, None, :]) / 2.0
                ).reshape(-1, 4, 3)
    return tets[:, np.asarray(FACES)].reshape(-1, 3, 3).astype(np.float32)


def _split(verts: np.ndarray, leaf: int) -> np.ndarray:
    """The median split of boxes given as (n, 3, 3) triangles: each
    one's (min, max, mean) of its three points."""
    return np.asarray(_bvh_order(verts.min(axis=1), verts.max(axis=1),
                                 verts.mean(axis=1), leaf), np.int64)


def order(tris: np.ndarray, leaf: int, super_leaf: int) -> np.ndarray:
    """The renderer's numpy-arm triangle order of ``tris`` (n, 3, 3),
    for n a multiple of ``leaf`` above 2 * ``super_leaf`` leaves."""
    v0 = tris[:, 0]
    verts = np.stack([v0, v0 + (tris[:, 1] - v0), v0 + (tris[:, 2] - v0)],
                     axis=1)
    first = _split(verts, leaf)
    n = first.shape[0]
    assert n % leaf == 0 and n // leaf > 2 * super_leaf, n
    c = n // leaf
    pts = verts[first]
    bmin = pts.min(axis=1).reshape(c, leaf, 3).min(axis=1)
    bmax = pts.max(axis=1).reshape(c, leaf, 3).max(axis=1)
    pad = 1e-4 * np.maximum(np.linalg.norm(bmax - bmin, axis=1,
                                           keepdims=True), 1.0) + 1e-6
    lo, hi = bmin - pad, bmax + pad
    boxes = np.stack([lo, hi, 0.5 * (lo + hi)], axis=1)
    second = _split(boxes, super_leaf)
    return first.reshape(c, leaf)[second].reshape(-1)


def build(cfg: dict, root: str, device) -> "object":
    sc = cfg["scene"]
    tris = faces(sc["level"], sc["centroid"])
    mat = material("standard", tuple(sc["colour"]), sc["smoothness"])
    b = Builder()
    for i in order(tris, sc["leaf"], sc["super_leaf"]):
        b.triangle(tris[i, 0], tris[i, 1], tris[i, 2], mat)
    return b.build(device)
