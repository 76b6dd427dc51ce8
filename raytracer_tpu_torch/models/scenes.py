"""The reference's five test scenes as scene-builder functions.

Mirrors ``SceneObjects`` (src/main.cu:94-296): scene 0 Cornell box + Suzanne
mesh + mirror sphere; 1 four spheres of varying smoothness; 2 textured
sphere + checkerboard triangle; 3 glass sphere; 4 RTiOW-style random
spheres over a checkered floor.

Mesh assets (cube.obj, low_poly_monkey.obj) are looked up in
$RAYTRACER_MODELS_DIR, then in the checkout's assets/models; when a file is
missing the scene takes the JAX package's procedural stand-in, an
80-triangle icosphere, so both packages build the same scene. Scene 2's
earth comes from the texture library (assets/textures.npz), else from a
procedural stand-in.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .materials import Material, Texture
from .obj_loader import ObjMesh
from .scene import SceneArrays, SceneBuilder

NUM_SCENES = 5

_MODEL_DIRS = (
    os.environ.get("RAYTRACER_MODELS_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "models"),
)


def find_model(name: str) -> Optional[str]:
    for d in _MODEL_DIRS:
        if not d:
            continue
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    return None


def _procedural_monkey() -> ObjMesh:
    """Stand-in mesh when low_poly_monkey.obj is unavailable: an icosahedron
    subdivided once (80 triangles)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    v_list = [v for v in verts]
    out_faces = []
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (v_list[a] + v_list[b]) / 2
            m = m / np.linalg.norm(m)
            cache[key] = len(v_list)
            v_list.append(m.astype(np.float32))
        return cache[key]

    for (a, b, c) in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return ObjMesh(np.stack(v_list),
                   [np.array(f, np.int32) for f in out_faces])


def load_mesh(name: str) -> ObjMesh:
    path = find_model(name)
    if path is not None:
        return ObjMesh.load(path)
    return _procedural_monkey()


def procedural_earth_texture(size: int = 64) -> np.ndarray:
    """Deterministic stand-in for the reference's earth.png (quirk #10): a
    latitude-banded, longitude-striped (size, 2 * size, 3) globe image."""
    v, u = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, 2 * size),
                       indexing="ij")
    land = (np.sin(u * 12.0) * np.cos(v * 9.0) + np.sin(u * 5.0 + 2.0)) > 0.3
    img = np.where(land[..., None],
                   np.array([0.2, 0.6, 0.2], np.float32),
                   np.array([0.1, 0.2, 0.7], np.float32))
    ice = (v < 0.08) | (v > 0.92)
    img = np.where(ice[..., None], np.array([0.9, 0.9, 0.95], np.float32),
                   img)
    return img.astype(np.float32)


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


def monkey_test_scene(b: SceneBuilder,
                      emissive_smoothness: float = 0.0) -> None:
    """Scene 0 (src/main.cu:150-170)."""
    create_cornell_box(b, (-0.5, 0.5, 1.2), 1, 1, 1, 0.5,
                       emissive_smoothness=emissive_smoothness)
    monkey_mat = Material.standard(Texture.const_colour((1, 1, 1)), 0)
    m = load_mesh("low_poly_monkey.obj")
    m.enlarge(0.3).rotate(0, 2.3, 0).translate(0.1, -0.1, 1.6)
    b.add_mesh(m.faces, monkey_mat)
    sphere_mat = Material.standard(Texture.const_colour((0.8, 0.8, 0.8)), 1)
    b.add_sphere((-0.25, -0.25, 1.95), 0.25, sphere_mat)


def reflection_test_scene(b: SceneBuilder) -> None:
    """Scene 1 (src/main.cu:172-187)."""
    create_cornell_box(b, (-0.5, 0.5, 1.2), 1, 1, 1, 0.5)
    tex = Texture.const_colour((1, 1, 1))
    for (x, y), smooth in [((-0.2, 0.2), 0), ((0.2, 0.2), 0.33),
                           ((-0.2, -0.2), 0.66), ((0.2, -0.2), 1)]:
        b.add_sphere((x, y, 1.7), 0.15, Material.standard(tex, smooth))


def texture_test_scene(b: SceneBuilder,
                       earth_image: Optional[np.ndarray] = None) -> None:
    """Scene 2 (src/main.cu:189-204). The earth is ``earth_image``, else
    earth.png from the texture library (256x512 in assets/textures.npz),
    else the procedural stand-in."""
    create_cornell_box(b, (-0.5, 0.5, 1.2), 1, 1, 1, 0.5)
    if earth_image is None:
        from ..utils.image import TextureLibrary, find_texture_library
        lib_path = find_texture_library()
        if lib_path is not None:
            try:
                earth_image = TextureLibrary(lib_path).get("earth.png")
            except (FileNotFoundError, KeyError):
                earth_image = None
    if earth_image is None:
        earth_image = procedural_earth_texture()
    earth_mat = Material.standard(Texture.from_image(earth_image), 0)
    b.add_sphere((0, 0, 1.7), 0.25, earth_mat)
    tri_mat = Material.standard(
        Texture.checkerboard((1, 1, 1), (0, 0, 0), 4), 0)
    b.add_triangle((0.1, 0, 1.7), (0.6, 0.5, 1.9), (0.8, 0.4, 2), tri_mat,
                   uvs=((0, 0), (0, 1), (1, 1)))


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
    """Build scene ``scene_num`` on ``device``; returns (scene, use_sky).
    Mirrors the SCENE_NUM switch (src/main.cu:100-122)."""
    b = SceneBuilder()
    if scene_num == 0:
        monkey_test_scene(b, **kwargs)
    elif scene_num == 1:
        reflection_test_scene(b)
    elif scene_num == 2:
        texture_test_scene(b, **kwargs)
    elif scene_num == 3:
        refract_test_scene(b)
    elif scene_num == 4:
        rand_sphere_test_scene(b, **kwargs)
    else:
        raise ValueError(
            f"Test scene must be a number between 0 and {NUM_SCENES - 1} "
            "(inclusive).")
    return b.build(device=device), b.use_sky
