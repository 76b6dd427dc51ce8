"""raytracer_tpu_torch scene build and packed layouts against raytracer_tpu.

The port's scene build must give the JAX package's arrays bit for bit:
every SceneArrays field, the sweep pools (pack_scene), the winner-parameter
planes (pack_param_planes), the material rows (pack_materials) and the
texel plane (pack_textures), for the five reference scenes and the bench
scenes.

Both packages build their BVH with the same native C++ library when g++
builds it (std::nth_element, whose partition order is the C++ library's
own) and with a numpy median split otherwise; the two builders order
primitives differently. Each package makes that choice the same way, so
the scenes are held equal in both arms: native in both (the default) and
numpy in both.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import bench_scenes as jbench
from raytracer_tpu.models import obj_loader as jobj
from raytracer_tpu.models.materials import Material as JMaterial
from raytracer_tpu.models.materials import Texture as JTexture
from raytracer_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu.ops import sweep as jsweep
from raytracer_tpu.runtime import loader as jloader
from raytracer_tpu_torch.models import bench_scenes as tbench
from raytracer_tpu_torch.models import obj_loader as tobj
from raytracer_tpu_torch.models.materials import Material, Texture
from raytracer_tpu_torch.models.scene import SceneBuilder
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import sweep as tsweep
from raytracer_tpu_torch.runtime import loader as tloader

torch.set_num_threads(2)

# Lane-traversal tables: a TPU scheduling device with no per-thread
# counterpart (ROADMAP "Not to be ported").
NOT_PORTED = {"sph_lane_clusters", "tri_lane_clusters", "sph_lane_leaf",
              "tri_lane_leaf"}
# name -> keyword arguments of the bench-scene function
BENCH = {"rtiow_trio": ("rtiow_trio_scene", {}),
         "cube": ("cube_scene", {}),
         "cube_image": ("cube_scene", {"image_texture": True}),
         "monkey_light": ("monkey_light_scene", {}),
         "stress": ("stress_10k_scene", {"num": 300, "seed": 2})}
SCENES = (0, 1, 2, 3, 4) + tuple(BENCH)


def jax_native_loaded() -> bool:
    """Whether the JAX package's scene build runs its native library. Its
    loader tries once per process and builds in place, so a build racing
    another test process can leave the library unloaded in this one; the
    loader is then asked again while the port's library builds."""
    for _ in range(5):
        if jloader._get_lib() is not None:
            return True
        if not tloader.native_available():
            return False
        jloader._lib_tried = False
        time.sleep(1.0)
    return False


@pytest.fixture
def native_bvh():
    """Both packages on their default build: native wherever g++ builds
    the host library, here as on the card's machine."""
    assert jax_native_loaded() == tloader.native_available()


@pytest.fixture
def numpy_bvh(monkeypatch):
    """Both packages on their numpy BVH build."""
    monkeypatch.setattr(jloader, "_get_lib", lambda: None)
    monkeypatch.setattr(tloader, "_get_lib", lambda: None)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want, equal_nan=True), what


def _scenes(name):
    if name in BENCH:
        fn, kw = BENCH[name]
        return getattr(tbench, fn)(**kw), getattr(jbench, fn)(**kw)
    return rtt.build_scene(name), rt.build_scene(name)


def _assert_scene_arrays_equal(name):
    (ts, t_sky), (js, j_sky) = _scenes(name)
    assert t_sky == j_sky
    t_names = {f.name for f in dataclasses.fields(ts)}
    j_names = {f.name for f in dataclasses.fields(js)}
    assert t_names == j_names - NOT_PORTED
    for field in sorted(t_names):
        got, want = getattr(ts, field), getattr(js, field)
        if isinstance(want, (bool, int, tuple)):
            assert got == want, field
        else:
            _assert_same(got, want, field)
    return ts


@pytest.mark.parametrize("num", SCENES)
def test_scene_arrays_equal(num, native_bvh):
    _assert_scene_arrays_equal(num)


@pytest.mark.parametrize("num", SCENES)
def test_scene_arrays_equal_numpy_bvh(num, numpy_bvh):
    _assert_scene_arrays_equal(num)


@pytest.mark.parametrize("num", SCENES)
def test_packed_layouts_equal(num, native_bvh):
    (ts, _), (js, _) = _scenes(num)
    for i, (got, want) in enumerate(zip(tsweep.pack_scene(ts),
                                        jsweep.pack_scene(js))):
        _assert_same(got, want, f"pack_scene[{i}]")
    for i, (got, want) in enumerate(zip(tsweep.pack_param_planes(ts),
                                        jsweep.pack_param_planes(js))):
        _assert_same(got, want, f"pack_param_planes[{i}]")
    _assert_same(tmk.pack_materials(ts), jmk.pack_materials(js),
                 "pack_materials")
    assert tsweep.param_rows(ts.num_spheres) == jsweep.param_rows(
        js.sph_center.shape[0])
    if js.img_rows:
        _assert_same(tmk.pack_textures(ts), jmk.pack_textures(js),
                     "pack_textures")


def test_codecs_round_trip_like_jax():
    g = np.random.default_rng(0)
    col = g.uniform(-0.2, 1.2, (257, 3)).astype(np.float32)
    smooth = g.uniform(-0.2, 1.2, 257).astype(np.float32)
    mat = g.integers(0, 300, 257).astype(np.int32)
    pa = tsweep.encode_colour30(torch.from_numpy(col))
    pb = tsweep.encode_smooth_mat(torch.from_numpy(smooth),
                                  torch.from_numpy(mat))
    _assert_same(pa, jsweep.encode_colour30(col), "colour30")
    _assert_same(pb, jsweep.encode_smooth_mat(smooth, mat), "smooth|mat")
    for got, want in zip(tsweep.decode_colour30(pa),
                         jsweep.decode_colour30(_np(pa))):
        _assert_same(got, want, "decode colour30")
    for got, want in zip(tsweep.decode_smooth_mat(pb),
                         jsweep.decode_smooth_mat(_np(pb))):
        _assert_same(got, want, "decode smooth|mat")
    _assert_same(tsweep.quantise_colour(col), jsweep.quantise_colour(col),
                 "quantise_colour")
    _assert_same(tsweep.quantise_smooth(smooth),
                 jsweep.quantise_smooth(smooth), "quantise_smooth")


def test_scene4_same_primitives_as_native_bvh_build(monkeypatch):
    """The numpy build holds the same spheres (centre, radius, material,
    colour, smoothness) and triangles as the native one, in another
    order."""
    tn, _ = rtt.build_scene(4, seed=0)
    monkeypatch.setattr(jloader, "_get_lib", lambda: None)
    monkeypatch.setattr(tloader, "_get_lib", lambda: None)
    ts, _ = rtt.build_scene(4, seed=0)
    js, _ = rt.build_scene(4, seed=0)
    numpy_order = _np(ts.sph_center)

    def rows(s, cols):
        table = np.concatenate(
            [_np(getattr(s, c)).reshape(_np(getattr(s, c)).shape[0], -1)
             .astype(np.float64) for c in cols], axis=1)
        return table[np.lexsort(table.T[::-1])]

    sph = ("sph_center", "sph_radius", "sph_mat", "sph_colour", "sph_smooth")
    tri = ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "tri_colour")
    for other in (js, tn):
        np.testing.assert_array_equal(rows(ts, sph), rows(other, sph))
        np.testing.assert_array_equal(rows(ts, tri), rows(other, tri))
    if tloader.native_available():
        assert not np.array_equal(numpy_order, _np(tn.sph_center))


def test_scene_device_and_unported_scenes():
    """Every reference scene builds (scene 0 with the stand-in mesh when
    low_poly_monkey.obj is missing, scene 2 with the library's earth)."""
    scene, _ = rtt.build_scene(4, seed=0, device="cpu")
    assert scene.device == torch.device("cpu")
    assert scene.to("cpu") is scene
    s0, sky0 = rtt.build_scene(0)
    assert not sky0 and s0.num_triangles >= 24 + 80 and not s0.has_image_tex
    s2, sky2 = rtt.build_scene(2)
    assert not sky2 and s2.has_image_tex and s2.needs_sphere_uv
    assert s2.img_layout == ((1, 256, 512, 0),) and s2.img_rows == 1024
    assert tmk.supports(s2)
    with pytest.raises(ValueError):
        rtt.build_scene(5)


OBJ_TEXT = """# a quad, a triangle with v/vt/vn triples, a tabbed line
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.5
vt 0.5 0.5
vn 0 0 1

f 1/1/1 2/1/1 3/1/1
f 1 2 3 4
f\t4//1 3//1 1//1
v\t2.0 -1.5 3.25
f 5 2 3
"""


@pytest.mark.parametrize("arm", ["native", "python"])
def test_parse_obj_matches_jax(arm, tmp_path, monkeypatch):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    if arm == "python":
        monkeypatch.setattr(jloader, "_get_lib", lambda: None)
        monkeypatch.setattr(tloader, "_get_lib", lambda: None)
    else:
        assert jax_native_loaded() and tloader.native_available()
    verts, faces = tloader.parse_obj(str(path))
    j_verts, j_faces = jloader.parse_obj(str(path))
    _assert_same(verts, j_verts, "vertices")
    assert len(faces) == len(j_faces) == 4
    for got, want in zip(faces, j_faces):
        _assert_same(got, want, "face")
    _assert_same(faces[1], np.array([0, 1, 2, 3], np.int32), "quad face")
    p_verts, p_faces = tobj.parse_obj_python(str(path))
    _assert_same(p_verts, verts, "python parser")
    with pytest.raises(FileNotFoundError):
        tloader.parse_obj(str(tmp_path / "missing.obj"))


def test_obj_mesh_and_add_mesh_match_jax(tmp_path, native_bvh):
    """ObjMesh transforms and add_mesh (quads become two triangles) give
    the JAX package's triangles and mesh ranges."""
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    t_mesh = tobj.ObjMesh.load(str(path))
    j_mesh = jobj.ObjMesh.load(str(path))
    t_mesh.enlarge(0.3).rotate(0.2, 2.3, -0.4).translate(0.1, -0.1, 1.6)
    j_mesh.enlarge(0.3).rotate(0.2, 2.3, -0.4).translate(0.1, -0.1, 1.6)
    _assert_same(t_mesh.vertices, j_mesh.vertices, "transformed vertices")
    tb, jb = SceneBuilder(), JBuilder()
    assert tb.add_mesh([], Material.default()) == 0
    jb.add_mesh([], JMaterial.default())
    assert tb.add_mesh(t_mesh.faces, Material.standard(
        Texture.gradient(), 0.5)) == 1
    jb.add_mesh(j_mesh.faces, JMaterial.standard(JTexture.gradient(), 0.5))
    assert tb.mesh_ranges == jb.mesh_ranges == [(0, 0), (0, 5)]
    ts, js = tb.build(), jb.build()
    for field in ("tri_v0", "tri_e1", "tri_e2", "tri_uv1", "tri_wu",
                  "tri_valid", "tri_mat", "tri_smooth"):
        _assert_same(getattr(ts, field), getattr(js, field), field)
    with pytest.raises(ValueError):
        tb.add_mesh([np.zeros((5, 3), np.float32)], Material.default())


def test_image_atlas_and_layout_match_jax():
    """compile_materials caches images by identity and quantises texels to
    k/1023; the layout gives each distinct image one band of packed rows
    (ceil(w / 128) rows per image row)."""
    g = np.random.default_rng(4)
    imgs = [g.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
            for h, w in ((3, 5), (4, 130), (2, 256))]
    centres = g.uniform(0, 1, (3, 3))

    def build(builder, material, texture):
        b = builder()
        texs = [texture.from_image(im) for im in imgs]
        for k, tex in enumerate(texs + [texture.from_image(imgs[0])]):
            b.add_sphere((k, 0, 3), 0.5, material.standard(tex, 0.25))
        b.add_sphere((0, 2, 3), 0.5, material.standard(texs[1], 0.75))
        b.add_spheres(centres, 0.1,
                      material.standard(texs[2], 0))
        return b.build()

    ts = build(SceneBuilder, Material, Texture)
    js = build(JBuilder, JMaterial, JTexture)
    for field in ("atlas", "tex_offset", "tex_width", "tex_height",
                  "tex_row", "tex_type", "sph_mat", "sph_colour"):
        _assert_same(getattr(ts, field), getattr(js, field), field)
    assert ts.img_layout == js.img_layout
    assert ts.img_rows == js.img_rows == 3 + 4 * 2 + 2 * 2
    q = _np(ts.atlas) * 1023.0
    np.testing.assert_allclose(q, np.round(q), atol=1e-3)
    _assert_same(tmk.pack_textures(ts), jmk.pack_textures(js),
                 "pack_textures")


def test_build_scene_kwargs_and_models_dir(tmp_path, monkeypatch):
    """Scene 2 takes an explicit earth image; scene 0 reads
    low_poly_monkey.obj from $RAYTRACER_MODELS_DIR, as the JAX package
    does."""
    earth = np.full((8, 16, 3), 0.5, np.float32)
    s2, _ = rtt.build_scene(2, earth_image=earth)
    assert s2.img_layout == ((1, 8, 16, 0),)
    (tmp_path / "low_poly_monkey.obj").write_text(OBJ_TEXT)
    from raytracer_tpu_torch.models import scenes as tscenes
    monkeypatch.setattr(tscenes, "_MODEL_DIRS", (str(tmp_path),))
    assert tscenes.find_model("low_poly_monkey.obj") == os.path.join(
        str(tmp_path), "low_poly_monkey.obj")
    assert tscenes.find_model("cube.obj") is None
    s0, _ = rtt.build_scene(0)
    assert s0.num_triangles == 32    # 24 box + 5 mesh triangles, padded
