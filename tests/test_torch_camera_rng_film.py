"""raytracer_tpu_torch camera, random streams, film and config against
raytracer_tpu: bitwise wherever both run the same operations."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.ops import film as jfilm
from raytracer_tpu_torch.models import camera as tcam
from raytracer_tpu_torch.ops import film as tfilm
from raytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

SIZES = ((1000, 800), (37, 23))


@pytest.mark.parametrize("width,height", SIZES + ((64, 64),))
def test_morton_order_equal(width, height):
    np.testing.assert_array_equal(tcam.morton_order(width, height),
                                  jcam.morton_order(width, height))


@pytest.mark.parametrize("width,height", SIZES)
def test_primary_rays_match(width, height):
    """Bitwise equal to raytracer_tpu's primary_rays run op by op, and
    within one ulp of a unit component (2**-23) of its jitted form, where
    XLA contracts the pixel-plane products into FMAs."""
    order = jcam.morton_order(width, height)
    cam = tcam.build_camera(rtt.CameraConfig(width=width, height=height))
    jc = jcam.build_camera(rt.CameraConfig(width=width, height=height))
    for field in ("position", "tl_pixel", "delta_u", "delta_v"):
        np.testing.assert_array_equal(getattr(cam, field),
                                      np.asarray(getattr(jc, field)))
    o, d = tcam.primary_rays(cam, width, height, pixel_order=order)
    assert o.shape == d.shape == (width * height, 3)
    assert o.dtype == d.dtype == torch.float32
    jo, jd = jcam.primary_rays(jc, width, height, pixel_order=order)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    jit = jax.jit(functools.partial(jcam.primary_rays, width=width,
                                    height=height))
    _, jd_jit = jit(jc, pixel_order=jnp.asarray(order))
    assert np.abs(d.numpy() - np.asarray(jd_jit)).max() <= 2.0 ** -23


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (0.3, -1.1, 2.0),
                                    (-0.7, 0.25, -0.05)])
def test_rotated_camera_matches(angles):
    from raytracer_tpu.utils import matrix as jmatrix
    from raytracer_tpu_torch.utils import matrix as tmatrix
    np.testing.assert_array_equal(tmatrix.rotate_xyz(*angles),
                                  jmatrix.rotate_xyz(*angles))
    kw = dict(width=37, height=23, position=(0.1, 0.5, -6.0),
              x_rot=angles[0], y_rot=angles[1], z_rot=angles[2])
    o, d = tcam.primary_rays(tcam.build_camera(rtt.CameraConfig(**kw)), 37, 23)
    jo, jd = jcam.primary_rays(jcam.build_camera(rt.CameraConfig(**kw)), 37, 23)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_threefry_check_value():
    """jax 0.9.0: key_data(fold_in(key(0), 3)) == [2467461003, 3840466878]."""
    k = trng.fold_in(trng.key(0), 3)
    assert trng.key_data(k).tolist() == [2467461003, 3840466878]


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1])
def test_threefry_key_fold_in_bitwise(seed):
    jk = jax.random.key(seed)
    tk = trng.key(seed)
    np.testing.assert_array_equal(trng.key_data(tk),
                                  np.asarray(jax.random.key_data(jk)))
    for frame in (0, 1, 3, 17, 1000, 2 ** 31 - 1, 2 ** 32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jk, frame)))
        got = trng.key_data(trng.frame_key(tk, frame))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint32
    # fold_in of a folded key (a key's history, not just one step)
    want = jax.random.key_data(
        jax.random.fold_in(jax.random.fold_in(jk, 5), 9))
    np.testing.assert_array_equal(
        trng.fold_in(trng.fold_in(tk, 5), 9), np.asarray(want))


def test_seed_words_match_megakernel_seed():
    """The seed the JAX wrapper hands its kernel (megakernel.py:1239-1241)."""
    jk = jax.random.fold_in(jax.random.key(7), 11)
    kd = jax.random.key_data(jk).astype(jnp.int32).reshape(-1)
    w0, w1, off = trng.seed_words(trng.fold_in(trng.key(7), 11), 5)
    assert (np.uint32(w0), np.uint32(w1)) == tuple(
        np.asarray(kd[:2]).view(np.uint32))
    assert off == 5


def _jax_hash(w0, w1_tile, itc, elem):
    """The interpret-mode hash as the JAX megakernel writes it
    (megakernel.py:564-570, stream salt lo = 0)."""
    x = (jnp.uint32(itc) * jnp.uint32(0x9E3779B9) + jnp.uint32(0)
         + elem) ^ w0
    x = (x ^ (x >> 16)) * jnp.uint32(0x85EBCA6B)
    x = x + w1_tile
    x = (x ^ (x >> 13)) * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def test_counter_hash_bitwise():
    g = np.random.default_rng(0)
    n = 4096
    elem = g.integers(0, 4 * 4096, n).astype(np.uint32)
    tiles = g.integers(0, 1 << 20, n).astype(np.int64)
    for w0, w1, itc in ((0, 0, 1), (2467461003, 3840466878, 2),
                        (0xFFFFFFFF, 0x80000000, 777), (12345, 999, 1 << 20)):
        # per-tile word 1, as the JAX kernel derives it in int32
        w1_tile = (jnp.int32(np.uint32(w1).view(np.int32))
                   + jnp.asarray(tiles.astype(np.int32))
                   * jnp.int32(-1640531527))
        w1_tile = jax.lax.bitcast_convert_type(w1_tile, jnp.uint32)
        got_w1 = trng.tile_w1(w1, torch.from_numpy(tiles))
        np.testing.assert_array_equal(got_w1.numpy(),
                                      np.asarray(w1_tile).astype(np.int64))
        want = _jax_hash(jnp.uint32(w0), w1_tile, itc, jnp.asarray(elem))
        got = trng.hash_bits(w0, got_w1, itc,
                             torch.from_numpy(elem.astype(np.int64)))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


def test_progressive_update_bitwise():
    g = np.random.default_rng(1)
    accum = g.uniform(0, 2, (500, 3)).astype(np.float32)
    for frame in (0, 1, 2, 7, 100):
        mean = g.uniform(0, 2, (500, 3)).astype(np.float32)
        want = jfilm.progressive_update(jnp.asarray(accum), jnp.asarray(mean),
                                        jnp.int32(frame))
        t_acc = torch.from_numpy(accum.copy())
        got = tfilm.progressive_update(t_acc, torch.from_numpy(mean), frame)
        assert got is t_acc    # in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        accum = np.asarray(want)


@pytest.mark.parametrize("gamma", [None, 2.2])
def test_to_u8_and_psnr_equal(gamma):
    g = np.random.default_rng(2)
    img = g.uniform(-0.5, 1.5, (37 * 23, 3)).astype(np.float32)
    want = jfilm.to_u8(jnp.asarray(img), 37, 23, gamma=gamma)
    np.testing.assert_array_equal(
        tfilm.to_u8(torch.from_numpy(img), 37, 23, gamma=gamma), want)
    np.testing.assert_array_equal(tfilm.to_u8(img, 37, 23, gamma=gamma), want)
    other = img + g.normal(0, 0.01, img.shape).astype(np.float32)
    assert tfilm.psnr(img, other) == jfilm.psnr(img, other)
    acc = tfilm.new_accumulator(37 * 23)
    assert acc.shape == (37 * 23, 3) and acc.dtype == torch.float32
    assert not acc.any()


def test_config_mirrors_jax():
    for tcls, jcls in ((rtt.RenderSettings, rt.RenderSettings),
                       (rtt.CameraConfig, rt.CameraConfig)):
        t_fields = {f.name: f.default for f in dataclasses.fields(tcls)}
        j_fields = {f.name: f.default for f in dataclasses.fields(jcls)}
        assert t_fields == j_fields
    cam = rtt.CameraConfig(width=37, height=23, fov_deg=45.0)
    jc = rt.CameraConfig(width=37, height=23, fov_deg=45.0)
    assert (cam.aspect, cam.fov_rad, cam.num_pixels) == (
        jc.aspect, jc.fov_rad, jc.num_pixels)
    s = rtt.RenderSettings().with_sky(False)
    assert s.sky_colour == rt.RenderSettings().with_sky(False).sky_colour
    from raytracer_tpu import config as jconfig
    from raytracer_tpu_torch import config as tconfig
    assert tconfig.ANTIALIAS_OFFSET_RANGE == jconfig.ANTIALIAS_OFFSET_RANGE


@pytest.mark.parametrize("kw", [{"coherent": True}, {"sampler": "regen"},
                                {"sampler": "scan"}, {"sampler": "lanesort"}])
def test_unported_settings_raise(kw):
    """Coherent (tile-shared) sampling is not ported, on any sampler; the
    wavefront samplers themselves are served."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        rtt.RenderSettings(**{**kw, "coherent": True})
    rtt.RenderSettings(**{**kw, "coherent": False})
    rtt.RenderSettings(sampler="mega", coherent=False)
