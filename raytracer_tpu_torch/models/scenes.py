"""The reference's test scenes as scene-builder functions.

Mirrors ``SceneObjects`` (src/main.cu:94-296). Scenes 1 (four spheres in a
Cornell box), 3 (glass sphere) and 4 (random spheres over a checker floor)
are ported. Scene 0 needs OBJ meshes and scene 2 an image texture; both are
ROADMAP item 7.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .materials import Material, Texture
from .scene import SceneArrays, SceneBuilder

NUM_SCENES = 5


def create_cornell_box(b: SceneBuilder, tl_near_pos, width: float,
                       height: float, depth: float, light_width: float,
                       emissive_smoothness: float = 0.0) -> None:
    """Cornell box: 5 quads + one-way front wall + emissive ceiling light
    (src/main.cu:252-288)."""
    b.use_sky = False

    floor = Material.standard(
        Texture.checkerboard((0.1, 0.8, 0.1), (0.1, 0.5, 0.1), 8), 0)
    l_wall = Material.standard(Texture.const_colour((1, 0.2, 0.2)), 0)
    r_wall = Material.standard(Texture.const_colour((0.3, 0.3, 1)), 0)
    back = Material.standard(Texture.const_colour((0.2, 0.2, 0.2)), 0)
    roof = Material.standard(Texture.const_colour((0.9, 0.9, 0.9)), 0)
    front = Material.standard(Texture.const_colour((1, 1, 1)), 0)

    p = np.asarray(tl_near_pos, np.float32)
    w = np.array([width, 0, 0], np.float32)
    h = np.array([0, height, 0], np.float32)
    d = np.array([0, 0, depth], np.float32)

    b.add_quad(p - h, p - h + w, p - h + w + d, p - h + d, floor)
    b.add_quad(p, p - h, p - h + d, p + d, l_wall)
    b.add_quad(p + w, p + w - h, p + w - h + d, p + w + d, r_wall)
    b.add_quad(p + d, p + w + d, p + w - h + d, p - h + d, back)
    b.add_quad(p, p + d, p + w + d, p + w, roof)
    # Front wall is one-way so the camera can see in (src/main.cu:279).
    b.add_one_way_quad(p, p + w, p + w - h, p - h, False, front)

    light_mat = Material.emissive((1, 1, 1), 6,
                                  smoothness=emissive_smoothness)
    light_tl = np.array(
        [p[0] + width / 2 - light_width / 2, p[1],
         p[2] + depth / 2 - light_width / 2], np.float32)
    b.add_cuboid(light_tl, light_width, 0.04, light_width, light_mat)


def reflection_test_scene(b: SceneBuilder) -> None:
    """Scene 1 (src/main.cu:172-187)."""
    create_cornell_box(b, (-0.5, 0.5, 1.2), 1, 1, 1, 0.5)
    tex = Texture.const_colour((1, 1, 1))
    for (x, y), smooth in [((-0.2, 0.2), 0), ((0.2, 0.2), 0.33),
                           ((-0.2, -0.2), 0.66), ((0.2, -0.2), 1)]:
        b.add_sphere((x, y, 1.7), 0.15, Material.standard(tex, smooth))


def refract_test_scene(b: SceneBuilder) -> None:
    """Scene 3 (src/main.cu:206-213)."""
    create_cornell_box(b, (-0.5, 0.5, 1.2), 1, 1, 1, 0.5)
    mat = Material.refractive(Texture.const_colour((1, 1, 1)), 1.5)
    b.add_sphere((0, -0.1, 1.7), 0.3, mat)


def rand_sphere_test_scene(b: SceneBuilder, num_spheres: int = 100,
                           seed: int = 0) -> None:
    """Scene 4, the RTiOW final render (src/main.cu:215-250), from a seeded
    generator with a defined white-diffuse default material."""
    rng = np.random.default_rng(seed)
    floor_y, floor_width, floor_depth = -1.0, 10.0, 10.0

    for _ in range(num_spheres):
        tex = Texture.const_colour(tuple(rng.uniform(0, 1, 3)))
        mat_num = rng.uniform()
        if mat_num < 0.3:
            mat = Material.standard(tex, float(rng.uniform(0, 1)))
        elif mat_num < 0.6:
            mat = Material.refractive(tex, float(rng.uniform(0.5, 2)))
        else:
            mat = Material.default()
        radius = float(rng.uniform(0.1, 0.5))
        center = (float(rng.uniform(-floor_width / 2, floor_width / 2)),
                  floor_y + radius,
                  float(rng.uniform(0, floor_depth)))
        b.add_sphere(center, radius, mat)

    floor_mat = Material.standard(
        Texture.checkerboard((0.7, 0.7, 0.7), (0.4, 0.4, 0.4), 10), 0)
    hw = floor_width / 2
    b.add_quad((-hw, floor_y, 0), (hw, floor_y, 0),
               (hw, floor_y, floor_depth), (-hw, floor_y, floor_depth),
               floor_mat)


def build_scene(scene_num: int, device="cpu",
                **kwargs) -> Tuple[SceneArrays, bool]:
    """Build scene ``scene_num`` on ``device``; returns (scene, use_sky)."""
    b = SceneBuilder()
    if scene_num in (0, 2):
        raise NotImplementedError(
            f"scene {scene_num} needs {'OBJ meshes' if scene_num == 0 else 'an image texture'}, "
            "which are not ported yet: ROADMAP item 7")
    if scene_num == 1:
        reflection_test_scene(b)
    elif scene_num == 3:
        refract_test_scene(b)
    elif scene_num == 4:
        rand_sphere_test_scene(b, **kwargs)
    else:
        raise ValueError(
            f"Test scene must be a number between 0 and {NUM_SCENES - 1} "
            "(inclusive).")
    return b.build(device=device), b.use_sky
