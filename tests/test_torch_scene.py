"""raytracer_tpu_torch scene build and packed layouts against raytracer_tpu.

The port's numpy scene build must give the JAX package's arrays bit for bit:
every SceneArrays field, the sweep pools (pack_scene), the winner-parameter
planes (pack_param_planes) and the material rows (pack_materials).

The JAX package builds its BVH with a native C++ library when one compiles
(std::nth_element, whose partition order is the C++ library's own) and with
a numpy median split otherwise. The port has only the numpy build (the
native host library is ROADMAP item 7), so these tests run the JAX package
on its numpy path, and one test checks that the two builds hold the same
primitives.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu.ops import sweep as jsweep
from raytracer_tpu.runtime import loader as jloader
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(2)

# Lane-traversal tables: a TPU scheduling device with no per-thread
# counterpart (ROADMAP "Not to be ported").
NOT_PORTED = {"sph_lane_clusters", "tri_lane_clusters", "sph_lane_leaf",
              "tri_lane_leaf"}
PORTED_SCENES = (1, 3, 4)


@pytest.fixture
def numpy_bvh(monkeypatch):
    """Run the JAX package's scene build on its numpy BVH path."""
    monkeypatch.setattr(jloader, "_get_lib", lambda: None)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want, equal_nan=True), what


def _scenes(num):
    return rtt.build_scene(num), rt.build_scene(num)


@pytest.mark.parametrize("num", PORTED_SCENES)
def test_scene_arrays_equal(num, numpy_bvh):
    (ts, t_sky), (js, j_sky) = _scenes(num)
    assert t_sky == j_sky
    t_names = {f.name for f in dataclasses.fields(ts)}
    j_names = {f.name for f in dataclasses.fields(js)}
    assert t_names == j_names - NOT_PORTED
    for name in sorted(t_names):
        got, want = getattr(ts, name), getattr(js, name)
        if isinstance(want, (bool, int, tuple)):
            assert got == want, name
        else:
            _assert_same(got, want, name)


@pytest.mark.parametrize("num", PORTED_SCENES)
def test_packed_layouts_equal(num, numpy_bvh):
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


def test_scene4_same_primitives_as_native_bvh_build():
    """With the native BVH the JAX scene holds the same spheres (centre,
    radius, material, colour, smoothness) and triangles, in another order."""
    ts, _ = rtt.build_scene(4, seed=0)
    js, _ = rt.build_scene(4, seed=0)

    def rows(s, cols):
        table = np.concatenate(
            [_np(getattr(s, c)).reshape(_np(getattr(s, c)).shape[0], -1)
             .astype(np.float64) for c in cols], axis=1)
        return table[np.lexsort(table.T[::-1])]

    sph = ("sph_center", "sph_radius", "sph_mat", "sph_colour", "sph_smooth")
    tri = ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "tri_colour")
    np.testing.assert_array_equal(rows(ts, sph), rows(js, sph))
    np.testing.assert_array_equal(rows(ts, tri), rows(js, tri))


def test_scene_device_and_unported_scenes():
    scene, _ = rtt.build_scene(4, seed=0, device="cpu")
    assert scene.device == torch.device("cpu")
    assert scene.to("cpu") is scene
    for num in (0, 2):
        with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
            rtt.build_scene(num)
    with pytest.raises(ValueError):
        rtt.build_scene(5)
