"""Benchmark scenes (port of ``raytracer_tpu/models/bench_scenes.py``).

They extend the five reference scenes (scenes.py) with the workloads of
benchmarks/suite.py: the RTiOW diffuse/metal/glass trio, the textured
cube.obj over a checkered floor, the Suzanne mesh with an emissive area
light and a dielectric, and the random-sphere stress scenes (10k, 100k);
besides, the SPD recursive tetrahedral pyramid (``spd_tetra_scene``), a
triangle mesh of 4^(L+1) faces.
Each returns (scene, use_sky) with the scene on ``device``: the card by
default, as ``build_scene``; ``device="cpu"`` builds on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .materials import Material, Texture
from .scene import SceneArrays, SceneBuilder
from .scenes import load_mesh, procedural_earth_texture


def rtiow_trio_scene(device="cuda") -> Tuple[SceneArrays, bool]:
    """Ground + 3 spheres (diffuse / metal / glass), the RTiOW chapter
    image."""
    b = SceneBuilder()
    ground = Material.standard(Texture.const_colour((0.8, 0.8, 0.0)), 0)
    b.add_sphere((0.0, -100.5, 1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, 1.2), 0.5,
                 Material.standard(Texture.const_colour((0.1, 0.2, 0.5)), 0))
    b.add_sphere((-1.0, 0.0, 1.2), 0.5,
                 Material.refractive(Texture.const_colour((1, 1, 1)), 1.5))
    b.add_sphere((1.0, 0.0, 1.2), 0.5,
                 Material.standard(Texture.const_colour((0.8, 0.6, 0.2)), 1))
    return b.build(device=device), True


def cube_scene(image_texture: bool = False,
               device="cuda") -> Tuple[SceneArrays, bool]:
    """cube.obj over a checkered floor, checkerboard-mapped, or mapped
    with a 32x64 image when ``image_texture``."""
    b = SceneBuilder()
    if image_texture:
        cube_tex = Texture.from_image(procedural_earth_texture(32))
    else:
        cube_tex = Texture.checkerboard((0.9, 0.3, 0.2), (0.95, 0.85, 0.7), 6)
    cube_mat = Material.standard(cube_tex, 0.2)
    m = load_mesh("cube.obj")
    m.enlarge(0.5).rotate(0.3, 0.6, 0.0).translate(0.0, 0.0, 2.5)
    b.add_mesh(m.faces, cube_mat)
    floor = Material.standard(
        Texture.checkerboard((0.9, 0.9, 0.9), (0.2, 0.2, 0.2), 12), 0)
    b.add_quad((-6, -1, -2), (6, -1, -2), (6, -1, 10), (-6, -1, 10), floor)
    return b.build(device=device), True


def monkey_light_scene(device="cuda") -> Tuple[SceneArrays, bool]:
    """low_poly_monkey.obj with an emissive area light and a dielectric
    sphere."""
    b = SceneBuilder()
    m = load_mesh("low_poly_monkey.obj")
    m.enlarge(0.5).rotate(0.0, 2.6, 0.0).translate(0.0, 0.0, 2.2)
    b.add_mesh(m.faces, Material.standard(
        Texture.const_colour((0.85, 0.75, 0.6)), 0.1))
    # area light above
    b.add_quad((-0.8, 1.4, 1.4), (0.8, 1.4, 1.4), (0.8, 1.4, 3.0),
               (-0.8, 1.4, 3.0), Material.emissive((1, 0.95, 0.9), 8))
    # dielectric sphere in front
    b.add_sphere((0.7, -0.3, 1.5), 0.3,
                 Material.refractive(Texture.const_colour((1, 1, 1)), 1.5))
    # floor
    b.add_quad((-6, -1, -2), (6, -1, -2), (6, -1, 10), (-6, -1, 10),
               Material.standard(Texture.const_colour((0.4, 0.4, 0.45)), 0))
    return b.build(device=device), True


def stress_10k_scene(num: int = 10000, seed: int = 1,
                     device="cuda") -> Tuple[SceneArrays, bool]:
    """``num`` random spheres over a checkered floor, through the bulk
    path (SceneBuilder.add_spheres); num=100000 is the 100k stress scene."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    centers = np.column_stack([
        rng.uniform(-15, 15, num),
        rng.uniform(-1, 6, num),
        rng.uniform(2, 30, num),
    ])
    b.add_spheres(
        centers,
        rng.uniform(0.08, 0.3, num),
        Material.standard(Texture.const_colour((1, 1, 1)), 0),
        colours=rng.uniform(0.2, 1, (num, 3)),
        smooth=rng.uniform(0, 0.6, num),
    )
    floor = Material.standard(
        Texture.checkerboard((0.7, 0.7, 0.7), (0.4, 0.4, 0.4), 20), 0)
    b.add_quad((-20, -1.3, -2), (20, -1.3, -2), (20, -1.3, 40),
               (-20, -1.3, 40), floor)
    return b.build(device=device), True


# The SPD pyramid's faces as vertex indices of a tetrahedron (apex first).
_TETRA_FACES = ((0, 1, 2), (0, 2, 3), (0, 3, 1), (1, 3, 2))


def spd_tetra_faces(level: int) -> np.ndarray:
    """(4 * 4^level, 3, 3) float32 faces of Haines' SPD recursive
    tetrahedral pyramid (``tetra.c``): a regular tetrahedron of
    circumradius 1, apex up, centroid (0, 0.2, 2.5), replaced ``level``
    times by its four half-size corner copies (corner i of T is
    ``(T + T[i]) / 2``), each output as its four faces."""
    base = np.array([[0.0, 1.0, 0.0],
                     [0.0, -1.0 / 3.0, -np.sqrt(8.0 / 9.0)],
                     [np.sqrt(2.0 / 3.0), -1.0 / 3.0, np.sqrt(2.0) / 3.0],
                     [-np.sqrt(2.0 / 3.0), -1.0 / 3.0, np.sqrt(2.0) / 3.0]])
    tets = (base + np.array([0.0, 0.2, 2.5]))[None]       # (1, 4, 3)
    for _ in range(level):
        # (n, corner i, vertex j): (T[j] + T[i]) / 2
        tets = ((tets[:, None, :, :] + tets[:, :, None, :]) / 2.0
                ).reshape(-1, 4, 3)
    return tets[:, np.asarray(_TETRA_FACES)].reshape(-1, 3, 3).astype(
        np.float32)


def spd_tetra_scene(level: int = 6,
                    device="cuda") -> Tuple[SceneArrays, bool]:
    """The SPD tetrahedral pyramid at ``level`` (4^(level+1) triangles, one
    diffuse material) under the sky, through the mesh path
    (``SceneBuilder.add_mesh``)."""
    b = SceneBuilder()
    b.add_mesh(spd_tetra_faces(level), Material.standard(
        Texture.const_colour((0.8, 0.3, 0.3)), 0))
    return b.build(device=device), True
