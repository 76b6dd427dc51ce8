"""Wavefront OBJ mesh loading with affine transforms.

Port of ``raytracer_tpu/models/obj_loader.py`` (reference: ``ObjFileMesh``,
src/obj_read.cu:47-146): ``v`` vertex lines and ``f`` face lines (only the
vertex index of ``v/vt/vn`` triples, 1-indexed), and enlarge / rotate /
translate on the vertex matrix; faces are views of the vertex pool, so
transforms compose as in the reference. ``ObjMesh.load`` parses with the
native host library when it builds (runtime/loader.py), else in Python.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils import matrix as hm


class ObjMesh:
    """Parsed OBJ mesh: ``vertices`` (N, 3) float32 + faces as index lists."""

    def __init__(self, vertices: np.ndarray, face_indices: List[np.ndarray]):
        self.vertices = np.asarray(vertices, np.float32)
        self.face_indices = [np.asarray(f, np.int32) for f in face_indices]

    @staticmethod
    def load(path: str) -> "ObjMesh":
        from ..runtime.loader import parse_obj
        vertices, faces = parse_obj(path)
        return ObjMesh(vertices, faces)

    # -- transforms (src/obj_read.cu:59-85) ---------------------------------
    def enlarge(self, scale: float) -> "ObjMesh":
        self.vertices = self.vertices @ hm.enlargement_matrix(scale).T
        return self

    def rotate(self, x_angle: float, y_angle: float,
               z_angle: float) -> "ObjMesh":
        self.vertices = self.vertices @ hm.rotate_xyz(x_angle, y_angle,
                                                      z_angle).T
        return self

    def translate(self, dx: float, dy: float, dz: float) -> "ObjMesh":
        self.vertices = self.vertices + np.array([dx, dy, dz], np.float32)
        return self

    @property
    def faces(self) -> List[np.ndarray]:
        """Faces as (k, 3) float vertex arrays (k = 3 or 4)."""
        return [self.vertices[idx] for idx in self.face_indices]


def parse_obj_python(path: str):
    """Pure-Python OBJ parser (mirrors src/obj_read.cu:90-146)."""
    vertices: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
            elif parts[0] == "f":
                # keep only the vertex index of v/vt/vn; OBJ is 1-indexed
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:]])
    return (np.asarray(vertices, np.float32),
            [np.asarray(f, np.int32) for f in faces])
