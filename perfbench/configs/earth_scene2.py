"""Plain reference scene of ``earth_scene2``: upstream SCENE_NUM 2
(src/main.cu:189-204): a Cornell box lit by an emissive ceiling cuboid,
an earth-textured sphere and a checkered triangle."""

from __future__ import annotations

import os

import numpy as np

from pbref.scene import Builder, material


def cornell_box(b: Builder, box: dict) -> None:
    """Five walls, a one-way front wall and the ceiling light
    (src/main.cu:252-288)."""
    p = np.asarray(box["top_left_near"], np.float32)
    width, height, depth = box["size"]
    w = np.array([width, 0, 0], np.float32)
    h = np.array([0, height, 0], np.float32)
    d = np.array([0, 0, depth], np.float32)
    walls = box["walls"]
    b.quad(p - h, p - h + w, p - h + w + d, p - h + d,
           material("standard", checker=tuple(walls["floor_checker"])))
    b.quad(p, p - h, p - h + d, p + d, material("standard", walls["left"]))
    b.quad(p + w, p + w - h, p + w - h + d, p + w + d,
           material("standard", walls["right"]))
    b.quad(p + d, p + w + d, p + w - h + d, p - h + d,
           material("standard", walls["back"]))
    b.quad(p, p + d, p + w + d, p + w, material("standard", walls["roof"]))
    b.one_way_quad(p, p + w, p + w - h, p - h,
                   material("standard", walls["front"]))
    lw = box["light_width"]
    colour, strength = box["light"]
    light = material("emissive", (0.0, 0.0, 0.0),
                     emit=tuple(float(c) * float(strength) for c in colour))
    tl = np.array([p[0] + width / 2 - lw / 2, p[1],
                   p[2] + depth / 2 - lw / 2], np.float32)
    b.cuboid(tl, lw, box["light_height"], lw, light)


def build(cfg: dict, root: str, device) -> "object":
    sc = cfg["scene"]
    b = Builder()
    cornell_box(b, sc["cornell_box"])
    earth = sc["earth"]
    with np.load(os.path.join(root, earth["library"])) as lib:
        image = np.asarray(lib[earth["image"]], np.float32)
    b.sphere(earth["centre"], earth["radius"],
             material("standard", image=image))
    tri = sc["triangle"]
    b.triangle(*tri["points"], material("standard",
                                        checker=tuple(tri["checker"])),
               uvs=tri["uvs"])
    return b.build(device)
