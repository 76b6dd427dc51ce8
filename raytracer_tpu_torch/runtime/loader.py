"""Host-side OBJ parsing and BVH construction (host CPU code).

Port of ``raytracer_tpu/runtime/loader.py``. The native C++ library
(``csrc/host_runtime.cpp``, a copy of the JAX package's) is built with g++
at first use into ``build/host/`` at the root of the checkout (listed in
.gitignore) and bound with ctypes. The choice is the JAX package's
(``loader._get_lib``): native when it builds, the numpy median split
otherwise. The two builders order primitives differently
(``std::nth_element`` against a numpy partition), so making the same choice
is what gives both packages the same scene on the same machine.
``native_available()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "host_runtime.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "host"
# the JAX package's flags (loader.build_native)
_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libraytracer_host_{h.hexdigest()[:16]}.so"


def build_native() -> Optional[pathlib.Path]:
    """Compile the host library unless it exists; None when g++ fails or
    is missing."""
    path = _library_path()
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_GXX_FLAGS, str(_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, path)
    return path


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    path = build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.rt_parse_obj.restype = ctypes.c_int
    lib.rt_parse_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # vertices out, cap
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,     # face idx out, cap
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,     # face sizes out, cap
        ctypes.POINTER(ctypes.c_int),                   # counts out (3)
    ]
    lib.rt_build_bvh.restype = ctypes.c_int
    lib.rt_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # tri verts (T*9), T
        ctypes.c_int,                                   # leaf size
        ctypes.POINTER(ctypes.c_int),                   # order out (T)
        ctypes.POINTER(ctypes.c_float),                 # node bounds out
        ctypes.POINTER(ctypes.c_int),                   # node meta out
        ctypes.POINTER(ctypes.c_int),                   # num nodes out
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the scene build runs the native C++ BVH and OBJ parser."""
    return _get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_obj(path: str) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Parse an OBJ file -> ((V, 3) float32 vertices, faces as 0-based
    int32 index arrays); native C++ when available, Python otherwise."""
    lib = _get_lib()
    if lib is None:
        from ..models.obj_loader import parse_obj_python
        return parse_obj_python(path)
    # Caps from the file size: a vertex line takes at least 7 bytes
    # ("v 0 0 0"), a face line 4 ("f 1\n") and a face index 2, so the
    # native parser cannot run out of room.
    size = os.path.getsize(path) + 1
    v_cap, f_cap, fi_cap = size // 7 + 1, size // 4 + 1, size // 2 + 1
    verts = np.zeros(v_cap * 3, np.float32)
    fidx = np.zeros(fi_cap, np.int32)
    fsize = np.zeros(f_cap, np.int32)
    counts = np.zeros(3, np.int32)
    rc = lib.rt_parse_obj(path.encode(), _ptr(verts, ctypes.c_float), v_cap,
                          _ptr(fidx, ctypes.c_int), fi_cap,
                          _ptr(fsize, ctypes.c_int), f_cap,
                          _ptr(counts, ctypes.c_int))
    if rc != 0:
        raise FileNotFoundError(f"Could not parse OBJ file: {path}")
    nv, nf, _ = (int(c) for c in counts)
    vertices = verts[:nv * 3].reshape(nv, 3).copy()
    ends = np.cumsum(fsize[:nf])
    faces = [fidx[e - k:e].copy() for e, k in zip(ends, fsize[:nf])]
    return vertices, faces


def build_bvh_clusters(tri_verts: np.ndarray, leaf_size: int = 64):
    """Median-split BVH over triangles; returns (order, node_bounds,
    node_meta).

    ``tri_verts`` is (T, 3, 3). ``order`` is a permutation of triangle
    indices so each leaf's triangles are contiguous; ``node_bounds`` is
    (num_nodes, 6) [min, max]; ``node_meta`` is (num_nodes, 4)
    [left, right, start, count] with left == -1 marking leaves. Native C++
    when available, numpy otherwise.
    """
    t = int(tri_verts.shape[0])
    if t == 0:
        return (np.zeros(0, np.int32), np.zeros((1, 6), np.float32),
                np.array([[-1, -1, 0, 0]], np.int32))
    lib = _get_lib()
    if lib is not None:
        flat = np.ascontiguousarray(tri_verts.reshape(t, 9), np.float32)
        order = np.zeros(t, np.int32)
        max_nodes = 4 * t + 2
        bounds = np.zeros((max_nodes, 6), np.float32)
        meta = np.zeros((max_nodes, 4), np.int32)
        n_nodes = np.zeros(1, np.int32)
        rc = lib.rt_build_bvh(_ptr(flat, ctypes.c_float), t, int(leaf_size),
                              _ptr(order, ctypes.c_int),
                              _ptr(bounds, ctypes.c_float),
                              _ptr(meta, ctypes.c_int),
                              _ptr(n_nodes, ctypes.c_int))
        if rc == 0:
            n = int(n_nodes[0])
            return order, bounds[:n].copy(), meta[:n].copy()
    return _build_bvh_python(tri_verts, leaf_size)


def _build_bvh_python(tri_verts: np.ndarray, leaf_size: int):
    """numpy median-split BVH (the build when the native library is
    missing)."""
    t = int(tri_verts.shape[0])
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
            sorted_idxs = idxs[np.argsort(centroids[idxs, axis],
                                          kind="stable")]
            l_idx, r_idx = sorted_idxs[:half], sorted_idxs[half:]
        else:
            l_idx, r_idx = idxs[left_mask], idxs[~left_mask]
        meta[node][0] = build(l_idx)
        meta[node][1] = build(r_idx)
        return node

    build(np.arange(t))
    return (np.asarray(order, np.int32), np.stack(bounds),
            np.asarray(meta, np.int32))
