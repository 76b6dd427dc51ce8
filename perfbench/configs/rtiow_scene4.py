"""Plain reference scene of ``rtiow_scene4``: upstream SCENE_NUM 4, the
Ray Tracing in One Weekend final render (src/main.cu:215-250): random
spheres over a checkered floor quad, drawn from a seeded generator."""

from __future__ import annotations

import numpy as np

from pbref.scene import Builder, material


def build(cfg: dict, root: str, device) -> "object":
    sc = cfg["scene"]
    rng = np.random.default_rng(sc["generator_seed"])
    b = Builder()
    floor_y, width, depth = sc["floor_y"], sc["floor_width"], \
        sc["floor_depth"]
    for _ in range(sc["num_spheres"]):
        colour = tuple(rng.uniform(0, 1, 3))
        kind = rng.uniform()
        if kind < 0.3:
            mat = material("standard", colour, float(rng.uniform(0, 1)))
        elif kind < 0.6:
            mat = material("refractive", colour,
                           ior=float(rng.uniform(0.5, 2)))
        else:   # the undefined upstream default, assumed white diffuse
            mat = material("standard", (1.0, 1.0, 1.0), 0.0)
        radius = float(rng.uniform(0.1, 0.5))
        centre = (float(rng.uniform(-width / 2, width / 2)),
                  floor_y + radius, float(rng.uniform(0, depth)))
        b.sphere(centre, radius, mat)
    light, dark, squares = sc["floor_checker"]
    floor = material("standard", checker=(light, dark, squares))
    hw = width / 2
    b.quad((-hw, floor_y, 0), (hw, floor_y, 0), (hw, floor_y, depth),
           (-hw, floor_y, depth), floor)
    return b.build(device)
