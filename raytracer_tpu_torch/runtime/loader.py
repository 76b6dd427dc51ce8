"""Host-side BVH construction for the scene build (numpy).

Only the median-split builder lives here. OBJ parsing and the native C++
host library are ROADMAP item 7; until then the port always takes this
pure-Python build, so its primitive order is that of the reference
package's Python path.
"""

from __future__ import annotations

from typing import List

import numpy as np


def build_bvh_clusters(tri_verts: np.ndarray, leaf_size: int = 64):
    """Median-split BVH over triangles; returns (order, node_bounds, node_meta).

    ``tri_verts`` is (T, 3, 3). ``order`` is a permutation of triangle
    indices so each leaf's triangles are contiguous; ``node_bounds`` is
    (num_nodes, 6) [min, max]; ``node_meta`` is (num_nodes, 4)
    [left, right, start, count] with left == -1 marking leaves.
    """
    t = int(tri_verts.shape[0])
    if t == 0:
        return (np.zeros(0, np.int32), np.zeros((1, 6), np.float32),
                np.array([[-1, -1, 0, 0]], np.int32))

    centroids = tri_verts.mean(axis=1)
    tri_min = tri_verts.min(axis=1)
    tri_max = tri_verts.max(axis=1)

    order: List[int] = []
    bounds: List[np.ndarray] = []
    meta: List[List[int]] = []

    def build(idxs: np.ndarray) -> int:
        node = len(meta)
        bmin = tri_min[idxs].min(axis=0)
        bmax = tri_max[idxs].max(axis=0)
        bounds.append(np.concatenate([bmin, bmax]).astype(np.float32))
        meta.append([-1, -1, 0, 0])
        if len(idxs) <= leaf_size:
            meta[node][2] = len(order)
            meta[node][3] = len(idxs)
            order.extend(int(i) for i in idxs)
            return node
        axis = int(np.argmax(bmax - bmin))
        med = np.median(centroids[idxs, axis])
        left_mask = centroids[idxs, axis] <= med
        if left_mask.all() or not left_mask.any():
            half = len(idxs) // 2
            sorted_idxs = idxs[np.argsort(centroids[idxs, axis], kind="stable")]
            l_idx, r_idx = sorted_idxs[:half], sorted_idxs[half:]
        else:
            l_idx, r_idx = idxs[left_mask], idxs[~left_mask]
        meta[node][0] = build(l_idx)
        meta[node][1] = build(r_idx)
        return node

    build(np.arange(t))
    return (np.asarray(order, np.int32), np.stack(bounds),
            np.asarray(meta, np.int32))
