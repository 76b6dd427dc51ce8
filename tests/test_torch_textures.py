"""raytracer_tpu_torch image textures against raytracer_tpu.

- The texel plane (``pack_textures``) and the plain image fetch
  (``fetch_image_reference``, the plain version of K4) against the JAX
  package's two fetches: the XLA atlas gather of ``sample_texture``
  (ops/textures.py:48-60) and the megakernel's ``_fetch_image``
  (megakernel.py:260) in Pallas interpret mode, bitwise. Interpret mode
  takes ``_fetch_image``'s static row select up to 64 packed rows and its
  clamped ``fori_loop`` above (hazard H6); past IMG_MAX_ROWS the JAX
  kernel pages the plane in from HBM. Each is held at widths 100, 128, 129
  and 512, the last three packing 1, 2 and 4 column blocks per image row.
- ``mega_reference`` on scene 2 (the 256x512 earth, 1024 packed rows)
  against the JAX megakernel in interpret mode, per pixel, and the
  Renderer's accumulator against one built from the JAX kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.models.materials import Material as JMaterial
from raytracer_tpu.models.materials import Texture as JTexture
from raytracer_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu.ops import tables as jtables
from raytracer_tpu.ops import textures as jtextures
from raytracer_tpu_torch.models.materials import Material, Texture
from raytracer_tpu_torch.models.scene import SceneBuilder
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

ROWS, LANES = 4, 128       # queries per fetch case: one (4, 128) block
LEAD = (3, 5)              # a small image packed first, so trow != 0
# regime -> (image height per column-block count, JAX IMG_MAX_ROWS)
REGIMES = {"static": (48, None),        # <= 64 rows: static row select
           "clamped": (1024, None),     # clamped fori_loop select
           "paged": (192, 64)}          # past IMG_MAX_ROWS: HBM pages
WIDTHS = (100, 128, 129, 512)


def _texture_scenes(h, w):
    """Port and JAX scenes with the lead image, an (h, w) image and a
    const-colour material, on three spheres."""
    g = np.random.default_rng(h * 1000 + w)
    imgs = [g.uniform(0, 1, (hh, ww, 3)).astype(np.float32)
            for hh, ww in (LEAD, (h, w))]
    out = []
    for builder, mat, tex in ((SceneBuilder, Material, Texture),
                              (JBuilder, JMaterial, JTexture)):
        b = builder()
        for k, im in enumerate(imgs):
            b.add_sphere((k, 0, 3), 0.5, mat.standard(tex.from_image(im), 0))
        b.add_sphere((0, 2, 3), 0.5,
                     mat.standard(tex.const_colour((0.3, 0.6, 0.9)), 0))
        out.append(b.build())
    return out


def _queries(n_mat, seed):
    """(u, v, mat id) of ROWS x LANES queries: UVs over [-0.05, 1.05], and
    in the first lanes exact edges, NaN, infinities and a huge value."""
    g = np.random.default_rng(seed)
    u = g.uniform(-0.05, 1.05, ROWS * LANES).astype(np.float32)
    v = g.uniform(-0.05, 1.05, ROWS * LANES).astype(np.float32)
    special = np.array([0, 1, np.nan, np.inf, -np.inf, 1e9, -1e9, 0.5],
                       np.float32)
    u[:8], v[8:16] = special, special
    mid = g.integers(0, n_mat, ROWS * LANES).astype(np.int32)
    return u, v, mid


def _jax_fetch_image(planes, img_rows, u, v, w, h, trow, paged):
    """The JAX megakernel's ``_fetch_image`` in a Pallas interpret-mode
    harness (as tests/test_megakernel.py runs it), over (ROWS, LANES)."""
    args = [jnp.asarray(x.reshape(ROWS, LANES)) for x in (u, v, w, h, trow)]
    out_shape = tuple(jax.ShapeDtypeStruct((ROWS, LANES), jnp.float32)
                      for _ in range(3))
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    if not paged:
        def kernel(tex_ref, u_ref, v_ref, w_ref, h_ref, row_ref, *outs):
            res = jmk._fetch_image(tex_ref, u_ref[:], v_ref[:], w_ref[:],
                                   h_ref[:], row_ref[:], img_rows=img_rows)
            for ref, x in zip(outs, res):
                ref[:] = x
        return pl.pallas_call(kernel, out_shape=out_shape,
                              in_specs=[vmem] * 6, out_specs=(vmem,) * 3,
                              interpret=True)(planes, *args)
    padded = max(jmk.IMG_PAGE, -(-img_rows // 8) * 8)
    planes = jnp.pad(planes, ((0, padded - planes.shape[0]), (0, 0)))

    def kernel(tex_ref, u_ref, v_ref, w_ref, h_ref, row_ref, r_ref, g_ref,
               b_ref, page_ref, sem):
        res = jmk._fetch_image(tex_ref, u_ref[:], v_ref[:], w_ref[:],
                               h_ref[:], row_ref[:], img_rows=img_rows,
                               page_ref=page_ref, page_sem=sem,
                               img_rows_padded=padded)
        for ref, x in zip((r_ref, g_ref, b_ref), res):
            ref[:] = x
    return pl.pallas_call(
        kernel, out_shape=out_shape,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] + [vmem] * 5,
        out_specs=(vmem,) * 3,
        scratch_shapes=[pltpu.VMEM((jmk.IMG_PAGE, 128), jnp.int32),
                        pltpu.SemaphoreType.DMA],
        interpret=True)(planes, *args)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_plain_fetch_matches_jax_fetches(regime, width, monkeypatch):
    rows_per_block, max_rows = REGIMES[regime]
    nb = -(-width // 128)
    ts, js = _texture_scenes(rows_per_block // nb, width)
    img_rows = js.img_rows
    assert ts.img_rows == img_rows == LEAD[0] + rows_per_block
    if max_rows is not None:
        monkeypatch.setattr(jmk, "IMG_MAX_ROWS", max_rows)
    paged = img_rows > jmk.IMG_MAX_ROWS
    assert paged == (regime == "paged")
    assert (img_rows <= 64) == (regime == "static")

    planes = tmk.pack_textures(ts)
    j_planes = jmk.pack_textures(js)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(j_planes))

    u, v, mid = _queries(ts.mat_type.shape[0], width)
    m = tmk.pack_materials(ts)[:, torch.from_numpy(mid).long()]
    mtw, mth, mtrow = m[tmk._M_TW], m[tmk._M_TH], m[tmk._M_TROW]
    got = torch.stack(tmk.fetch_image_reference(
        planes, img_rows, torch.from_numpy(u), torch.from_numpy(v), mtw,
        mth, mtrow)).numpy()
    assert np.isfinite(got).all()

    want = np.stack([np.asarray(x).reshape(-1) for x in _jax_fetch_image(
        j_planes, img_rows, u, v, mtw.numpy(), mth.numpy(), mtrow.numpy(),
        paged)])
    np.testing.assert_array_equal(got, want)

    # the XLA atlas gather, on the lanes whose material is an image
    cols = jtables.lookup_material(js, jnp.asarray(mid))
    gather = np.asarray(jtextures.sample_texture(
        js, cols, jnp.asarray(u), jnp.asarray(v),
        jnp.zeros((3, mid.shape[0]), jnp.float32)))
    is_img = np.asarray(js.tex_type)[mid] == 3
    assert is_img.mean() > 0.5
    np.testing.assert_array_equal(got[:, is_img], gather[:, is_img])

    # the wrapper's CPU path is the plain version, with no launch
    before = tmk.FETCH_LAUNCHES
    out = tmk.fetch_image(tmk.MegaScene(ts), torch.from_numpy(u),
                          torch.from_numpy(v), torch.from_numpy(mid))
    np.testing.assert_array_equal(out.numpy(), got)
    assert tmk.FETCH_LAUNCHES == before


def test_fetch_image_wrapper_checks_inputs():
    ts, _ = _texture_scenes(4, 100)
    ms = tmk.MegaScene(ts)
    u = torch.zeros(10)
    mid = torch.zeros(10, dtype=torch.int32)
    # material ids are clamped to the table, in the kernel as here
    far = tmk.fetch_image(ms, u, u, mid + 100)
    np.testing.assert_array_equal(far.numpy(), tmk.fetch_image(
        ms, u, u, mid + ms.mat.shape[1] - 1).numpy())
    with pytest.raises(ValueError):
        tmk.fetch_image(ms, u.double(), u, mid)
    with pytest.raises(ValueError):
        tmk.fetch_image(ms, u, u, mid.long())
    with pytest.raises(ValueError):
        tmk.fetch_image(ms, u, u[:5], mid)
    with pytest.raises(ValueError):
        tmk.fetch_image(ms, u.to("meta"), u.to("meta"), mid.to("meta"))
    scene4, _ = rtt.build_scene(4, seed=0)
    with pytest.raises(ValueError, match="no image"):
        tmk.fetch_image(tmk.MegaScene(scene4), u, u, mid)


# Scene 2 through the megakernel, with per-pixel bounds as in
# test_torch_megakernel.py. The two sides round some products, rsqrt and
# asin differently (see there), but in this closed box every surface but
# the earth is flat, so a radiance is a product of quantised colours and
# the emission, and it moves only where a path turns another way or an
# earth UV crosses a texel edge. Measured at 64x64, spp 2, 5 bounces, on
# frames 0, 1, 3 and 5 at pixpack 1 and 2: every pixel equal (100% within
# 1e-4, mean |d| 0), primary depth within 2.7e-5. The bounds leave room
# for a texel edge or a path that turns.
PIXEL_ABS = 1e-4
SCENE2_SHARE_MIN = 0.99
SCENE2_MEAN_MAX = 1e-3
SEGS_REL = 5e-3
W = H = 64


@functools.lru_cache(maxsize=None)
def _scene2_rays():
    order = jcam.morton_order(W, H)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=W, height=H)), W, H,
        pixel_order=order)
    return np.asarray(o).T.copy(), np.asarray(d).T.copy()


@functools.lru_cache(maxsize=None)
def _jax_scene2_frames(frames=2):
    """The JAX megakernel (interpret mode) on scene 2: (mean, segs,
    depth) of frames 0..frames-1 under base key 0."""
    js, sky = rt.build_scene(2)
    settings = rt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                                 antialias=True, pixpack=1).with_sky(sky)
    o, d = _scene2_rays()
    out = []
    for frame in range(frames):
        fkey = jrng.frame_key(jax.random.key(0), frame)
        m, s, dep = jmk.render_sample_mean_mega(js, settings, o, d, fkey,
                                                want_depth=True, pixpack=1)
        out.append((np.asarray(m), float(s), np.asarray(dep)))
    return out


@pytest.mark.parametrize("frame", [0, 1])
def test_scene2_mega_reference_matches_jax_interpret(frame):
    ts, sky = rtt.build_scene(2)
    settings = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    o, d = _scene2_rays()
    tm, tsegs, td = tmk.render_sample_mean_mega(
        ts, settings, torch.from_numpy(o), torch.from_numpy(d),
        trng.frame_key(trng.key(0), frame), want_depth=True, pixpack=1)
    jm, jsegs, jd = _jax_scene2_frames()[frame]
    tm, td = tm.numpy(), td.numpy()
    assert tm.shape == jm.shape == (3, W * H) and np.isfinite(tm).all()
    err = np.abs(tm - jm)
    assert (err.max(axis=0) <= PIXEL_ABS).mean() >= SCENE2_SHARE_MIN
    assert err.mean() <= SCENE2_MEAN_MAX
    assert abs(float(tsegs) - jsegs) <= SEGS_REL * jsegs
    np.testing.assert_array_equal(td < tmk.INF, jd < jmk._INF)
    # the earth is in view: some primary rays hit the image material
    ms = tmk.MegaScene(ts)
    hit = torch.from_numpy(td < tmk.INF)
    assert ms.img_rows == 1024 and bool(hit.any())


def test_scene2_renderer_matches_jax_accumulator():
    scene, sky = rtt.build_scene(2)
    settings = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                                  antialias=True, pixpack=1).with_sky(sky)
    r = rtt.Renderer(scene, rtt.CameraConfig(width=W, height=H), settings,
                     seed=0, device="cpu")
    o, d = _scene2_rays()
    np.testing.assert_array_equal(r._o.numpy(), o.T)
    np.testing.assert_array_equal(r._d.numpy(), d.T)
    r.render_frames(2)
    accum = np.zeros((W * H, 3), np.float32)
    for frame, (mean, _, _) in enumerate(_jax_scene2_frames()):
        fn = np.float32(frame)
        accum = (mean.T + accum * fn) / (fn + np.float32(1.0))
    err = np.abs(r.accum.numpy() - accum)
    assert (err.max(axis=1) <= PIXEL_ABS).mean() >= SCENE2_SHARE_MIN
    assert err.mean() <= SCENE2_MEAN_MAX
    r.check_health()
