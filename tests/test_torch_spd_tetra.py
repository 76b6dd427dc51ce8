"""The SPD recursive tetrahedral pyramid (``bench_scenes.spd_tetra_scene``)
on the CPU: its geometry, the hierarchy the port builds for it at levels
4 and 6, the benchmark's plain reference scene (perfbench/configs/
spd_tetra6.py) in the port's numpy-arm triangle order, the port's plain
frames against that reference, and the scene build's spans."""

import ast
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.models import bench_scenes
from raytracer_tpu_torch.models import scene as tscene
from raytracer_tpu_torch.ops import intersect_cuda as ic
from raytracer_tpu_torch.runtime import loader
from raytracer_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
CONFIG = os.path.join(BENCH, "configs", "spd_tetra6")
CENTROID = np.array([0.0, 0.2, 2.5])
SEED = 5_000_000_017

torch.set_num_threads(2)


@pytest.fixture
def numpy_arm(monkeypatch):
    """The port's numpy BVH arm, whether or not g++ built the native one."""
    monkeypatch.setattr(loader, "_get_lib", lambda: None)


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's harness and reference on the import path."""
    monkeypatch.syspath_prepend(BENCH)
    from pbench import spec
    return spec


def _reference_module(spec):
    return spec.load_module(CONFIG + ".py", "spd_tetra6_reference")


def _config(level):
    with open(CONFIG + ".json") as f:
        cfg = json.load(f)
    cfg["scene"]["level"] = level
    cfg["program"]["kwargs"]["level"] = level
    return cfg


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_geometry(level):
    """4^L tetrahedra of 4 faces; every vertex on or inside the
    circumsphere of radius 1, the four corners of the first on it."""
    faces = bench_scenes.spd_tetra_faces(level)
    assert faces.shape == (4 * 4 ** level, 3, 3)
    assert faces.dtype == np.float32
    tets = faces.reshape(4 ** level, 4, 3, 3)
    # a tetrahedron's four faces use its four corners, apex first
    assert np.array_equal(tets[:, 0, 0], tets[:, 1, 0])
    pts = faces.reshape(-1, 3).astype(np.float64)
    r = np.linalg.norm(pts - CENTROID, axis=1)
    assert abs(r.max() - 1.0) < 1e-6
    corners = CENTROID + np.array([[0.0, 1.0, 0.0],
                                   [0.0, -1 / 3, -np.sqrt(8 / 9)],
                                   [np.sqrt(2 / 3), -1 / 3, np.sqrt(2) / 3],
                                   [-np.sqrt(2 / 3), -1 / 3, np.sqrt(2) / 3]])
    assert np.allclose(pts.min(axis=0), corners.min(axis=0), atol=1e-6)
    assert np.allclose(pts.max(axis=0), corners.max(axis=0), atol=1e-6)
    for c in corners:
        assert np.linalg.norm(pts - c, axis=1).min() < 1e-6
    # half-size copies: every edge 2^-L of the first's
    edge = np.linalg.norm(tets[:, 0, 1] - tets[:, 0, 0], axis=1)
    assert np.allclose(edge, np.sqrt(8 / 3) / 2 ** level, rtol=1e-5)


@pytest.mark.parametrize("level,clusters,supers,fits", [
    (4, 32, 4, True), (6, 512, 64, False)])
def test_hierarchy(level, clusters, supers, fits):
    """Leaves of 32 under supers of 8 leaves: level 4 stays resident (K5),
    level 6 is past the budget (K6, 16 blocks)."""
    scene, sky = bench_scenes.spd_tetra_scene(level, device="cpu")
    assert sky is True
    rec = dict(tscene.LAST_BUILD)
    assert rec["triangles"] == 4 ** (level + 1) and rec["spheres"] == 0
    assert rec["tri_leaf"] == 32
    assert (rec["tri_clusters"], rec["tri_supers"]) == (clusters, supers)
    assert (rec["sph_clusters"], rec["sph_supers"]) == (0, 0)
    assert rec["host_ms"] > 0
    assert tuple(scene.tri_clusters.shape) == (clusters, 8)
    assert ic.fits_smem(scene) is fits
    # 8..512 top boxes get the per-cell order (4^3 cells)
    assert scene.tri_cell_order.shape[0] == (64 * supers if supers >= 8
                                             else 1)
    if not fits:
        assert ic.blocked_tables(scene).nblocks == 16


def test_reference_imports_nothing_of_the_port():
    with open(CONFIG + ".py") as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "numpy", "pbref"}, names


@pytest.mark.parametrize("level", [4, 6])
def test_reference_order_is_the_numpy_arms(level, numpy_arm, bench):
    """The reference's triangles are the port's, index for index, when
    the port builds its BVH with numpy."""
    scene, _ = bench_scenes.spd_tetra_scene(level, device="cpu")
    ref = _reference_module(bench).build(_config(level), ROOT, "cpu")
    n = 4 ** (level + 1)
    assert ref.tri_w.shape[0] == n and ref.n_sph == 0
    port_w = torch.cat([scene.tri_wu, scene.tri_wv, scene.tri_ww], dim=1)
    assert torch.equal(port_w[:n], ref.tri_w)
    assert torch.equal(scene.tri_normal[:n], ref.tri_n)
    assert bool(scene.tri_valid[:n].all())


@pytest.mark.parametrize("traffic", ["progressive", "regen"])
def test_cpu_frames_match_the_reference(traffic, numpy_arm, bench):
    """The port's plain frames at level 4 (``mega_reference`` under
    ``auto``, the regen plain path under ``regen``), 40x32, 3 spp, two
    frames or more, against the benchmark's reference at 256 lanes."""
    from pbench import cell as cell_run
    c = bench.load(ROOT, "spd_tetra6." + traffic)
    cfg = _config(4)
    c = dataclasses.replace(
        c, config=cfg,
        traffic={**c.traffic, "width": 40, "height": 32, "spp": 3,
                 "warmup_frames": 1},
        check={**c.check, "lanes": 256})
    out = cell_run.run(c, SEED, 0.2, False, torch.device("cpu"),
                       time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    [(name, gap, limit)] = out["checks"]
    assert name == "film_gap" and limit == 3e-3 and gap <= 3e-3


def test_spans_leave_the_scene_bitwise():
    """Spans on: ``scene.build`` with ``scene.woop`` and ``scene.bvh``
    inside it, and ``wave.blocked``; the scene and its blocked layout are
    bitwise those built with spans off."""
    trace.enable(False)
    trace.take()
    built = {}
    try:
        for on in (True, False):
            trace.enable(on)
            scene, _ = bench_scenes.spd_tetra_scene(4, device="cpu")
            ws = ic.WaveScene(scene, blocked=True)
            trace.enable(False)
            built[on] = (scene, ws.tables, trace.take())
    finally:
        trace.enable(False)
        trace.take()
    spans = built[True][2]
    assert built[False][2] == []
    named = [(n, None if p is None else spans[p][0]) for n, _, _, p, _
             in spans]
    assert ("scene.build", None) in named
    assert ("scene.woop", "scene.build") in named
    assert ("scene.bvh", "scene.build") in named
    assert ("wave.blocked", None) in named
    for obj_on, obj_off in zip(built[True][:2], built[False][:2]):
        for f in dataclasses.fields(obj_on):
            a, b = getattr(obj_on, f.name), getattr(obj_off, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.nan_to_num(), b.nan_to_num()), f.name
                assert torch.equal(a.isnan(), b.isnan()), f.name
            else:
                assert a == b, f.name
