"""Benchmark scenes (port of ``raytracer_tpu/models/bench_scenes.py``).

They extend the five reference scenes (scenes.py) with the workloads of
benchmarks/suite.py: the RTiOW diffuse/metal/glass trio, the textured
cube.obj over a checkered floor, the Suzanne mesh with an emissive area
light and a dielectric, and the random-sphere stress scenes (10k, 100k).
Each returns (scene, use_sky) with the scene on the CPU
(``SceneArrays.to`` moves it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .materials import Material, Texture
from .scene import SceneArrays, SceneBuilder
from .scenes import load_mesh, procedural_earth_texture


def rtiow_trio_scene() -> Tuple[SceneArrays, bool]:
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
    return b.build(), True


def cube_scene(image_texture: bool = False) -> Tuple[SceneArrays, bool]:
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
    return b.build(), True


def monkey_light_scene() -> Tuple[SceneArrays, bool]:
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
    return b.build(), True


def stress_10k_scene(num: int = 10000,
                     seed: int = 1) -> Tuple[SceneArrays, bool]:
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
    return b.build(), True
