"""raytracer_tpu_torch temporal mode against raytracer_tpu, on the CPU.

- The plain warp gather (K7's contract) is bitwise JAX's ``banded_gather``
  in Pallas interpret mode on test_warp.py's index patterns.
- ``pack_history`` is bitwise ``_pack_history_body``.
- ``gather_history`` (pack and gather) against ``_pack_history_body`` then
  ``_gather_history``: the source pixel of every current pixel, its weight
  and its history. With an
  unrotated old camera every dot product of the projection has one
  nonzero term, so XLA's FMA contraction changes nothing and both agree
  bitwise. A rotated old camera makes XLA's fused dots round otherwise
  (ROADMAP F2): the source pixel still agrees on >= 99.9% of pixels, but
  the weight's velocity cap moves with x and y by up to 2.3e-4 of itself
  (measured on the case below), so it is held relatively there.
- The temporal ``Renderer`` on the CPU against the same steps composed
  from JAX's own functions (JAX's Renderer serves temporal mode only on a
  TPU, renderer.py:163-165): frames, a dolly, a yaw.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu.runtime.renderer as jrd
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu.ops.warp import LANES, PAGE, TROWS, banded_gather
from raytracer_tpu_torch.models import camera as tcam
from raytracer_tpu_torch.ops import warp
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(2)

_SCALE = np.float32(8.0 / (511.0 * 511.0))


def index_history(n, device="cpu"):
    """An old accumulation whose pack at pixel j is the word
    ``(j << 5) | 31`` (j < 2^27): each channel holds the decode of one
    9-bit digit of j, which packs back to that digit. With weights 31 and
    a cap of 31, the gather's hist spells the source pixel of every valid
    pixel and w > 0 exactly there (``source_pixels``)."""
    j = torch.arange(n, dtype=torch.int32, device=device)
    q = torch.stack([(j >> s) & 511 for s in (18, 9, 0)], 1).float()
    return (q * q) * float(_SCALE), torch.full((n,), 31.0, device=device)


def source_pixels(hist, w):
    """The source pixel of each pixel that the gather gave over
    ``index_history``, -1 where it gave no weight."""
    q = torch.round(torch.sqrt((hist / float(_SCALE)).double())).int()
    j = (q[:, 0] << 18) | (q[:, 1] << 9) | q[:, 2]
    return torch.where(w > 0, j, -1)


# -- K7: the warp gather ----------------------------------------------------

def _coherent_band(rng):
    m, n = 64 * LANES, 2 * TROWS * LANES
    idx = np.clip(np.arange(n) // 4 + rng.integers(-64, 64, n), 0, m - 1)
    return m, idx, rng.uniform(size=n) < 0.9


def _random_full_range(rng):
    m, n = 64 * LANES, TROWS * LANES + 300      # ragged n
    return m, rng.integers(0, m, n), rng.uniform(size=n) < 0.7


def _all_invalid_tile(rng):
    m, n = 32 * LANES, 2 * TROWS * LANES
    valid = np.zeros(n, bool)
    valid[TROWS * LANES:] = rng.uniform(size=TROWS * LANES) < 0.5
    return m, rng.integers(0, m, n), valid


def _boundary_rows(rng):
    m, n = 16 * LANES + 37, TROWS * LANES       # ragged plane
    idx = np.concatenate([np.zeros(n // 2, np.int64),
                          np.full(n - n // 2, m - 1, np.int64)])
    return m, idx, np.ones(n, bool)


@pytest.mark.parametrize("pattern", [_coherent_band, _random_full_range,
                                     _all_invalid_tile, _boundary_rows],
                         ids=lambda f: f.__name__.strip("_"))
def test_warp_gather_matches_banded_gather(pattern):
    """test_warp.py's four patterns, the same values through both."""
    rng = np.random.default_rng(1)
    m, idx, valid = pattern(rng)
    values = rng.integers(-2**31, 2**31 - 1, m, dtype=np.int64).astype(
        np.int32)
    want = np.asarray(banded_gather(jnp.asarray(values),
                                    jnp.asarray(idx, jnp.int32),
                                    jnp.asarray(valid)))
    args = (torch.from_numpy(values), torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(valid))
    np.testing.assert_array_equal(warp.warp_gather_reference(*args).numpy(),
                                  want)
    before = trace.counts()
    np.testing.assert_array_equal(warp.warp_gather(*args).numpy(), want)
    assert trace.counts() == before     # CPU tensors launch nothing


def test_warp_gather_cross_page_and_clamp():
    """A plane past JAX's in-VMEM threshold, with a band across a DMA page
    boundary (test_warp.py's slow case), against a numpy oracle; indices
    out of range are clamped before the load."""
    m, n = (2 * PAGE + 192) * LANES, TROWS * LANES
    rng = np.random.default_rng(4)
    idx = (PAGE - 40) * LANES + rng.integers(0, 80 * LANES, n)
    valid = rng.uniform(size=n) < 0.95
    values = rng.integers(-2**31, 2**31 - 1, m, dtype=np.int64).astype(
        np.int32)
    got = warp.warp_gather(torch.from_numpy(values),
                           torch.from_numpy(idx.astype(np.int32)),
                           torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(valid, values[idx], 0))
    edge = warp.warp_gather(torch.from_numpy(values),
                            torch.tensor([-5, m, m + 7], dtype=torch.int32),
                            torch.tensor([True, True, False]))
    assert edge.tolist() == [values[0], values[m - 1], 0]


def test_warp_gather_rejects_bad_inputs():
    v = torch.zeros(8, dtype=torch.int32)
    i = torch.zeros(4, dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    for args in ((v.long(), i, ok), (v, i.long(), ok), (v, i, ok.int()),
                 (v, i, ok[:3]), (v[:0], i, ok), (v, i, ok.to("meta"))):
        with pytest.raises(ValueError):
            warp.warp_gather(*args)


# -- the packed history -------------------------------------------------------

def test_pack_history_matches_jax():
    """0, values past HIST_MAX (q = 511: the red field sets bit 31),
    negatives, and weights past 31 and past the cap."""
    rng = np.random.default_rng(2)
    n = 50_000
    accum = rng.uniform(-1.0, 12.0, (n, 3)).astype(np.float32)
    accum[:100] = 0.0
    accum[100:200] = 8.0
    accum[200:300] = rng.uniform(8.0, 1e6, (100, 3))
    wpix = rng.uniform(0.0, 80.0, n).astype(np.float32)
    wpix[:50] = 0.0
    for cap in (8.0, 40.0):
        want = np.asarray(jrd._pack_history_body(
            jnp.asarray(accum), jnp.asarray(wpix), None, jnp.float32(cap)))
        got = warp.pack_history(torch.from_numpy(accum),
                                torch.from_numpy(wpix), cap).numpy()
        np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got & 31).max() == 31


# -- the history gather ------------------------------------------------------

# (width, height, new camera, old camera, seed) per case: test_warp.py's
# 96x64 move, a 960x540 move (the 4K fly-through's aspect) from the
# default camera, and one from a rotated old camera.
GATHER_CASES = {
    "test_warp_96x64": (96, 64, dict(position=(0.05, 0.02, -0.1),
                                     y_rot=0.03), {}, 7),
    "random_960x540": (960, 540, dict(position=(0.1, -0.05, 0.25),
                                      y_rot=-0.02, x_rot=0.01), {}, 8),
    "rotated_old_960x540": (960, 540, dict(position=(0.3, 0.45, -5.75),
                                           y_rot=0.05, x_rot=0.1),
                            dict(position=(0.2, 0.5, -6.0), y_rot=0.02,
                                 x_rot=0.08, z_rot=0.01), 9),
}


def _gather_pair(width, height, new, old, seed, accum, wpix, cap):
    """JAX's pack and _gather_history and the port's gather_history on the
    same rays of the new view, random depths (a fifth missed) and old
    accumulation."""
    n = width * height
    rng = np.random.default_rng(seed)
    order = np.arange(n, dtype=np.int32)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=width, height=height,
                                          **new)),
        width, height, pixel_order=order)
    depth = rng.uniform(0.5, 6.0, n).astype(np.float32)
    depth[: n // 5] = 1e30
    cj = jcam.build_camera(rt.CameraConfig(width=width, height=height,
                                           **old))
    packed = jrd._pack_history_body(jnp.asarray(accum), jnp.asarray(wpix),
                                    None, jnp.float32(cap))
    hj, wj = jrd._gather_history(width, height, jnp.asarray(order), o, d,
                                 jnp.asarray(depth), packed, cj.position,
                                 cj.tl_pixel, cj.delta_u, cj.delta_v)
    ct = tcam.build_camera(rtt.CameraConfig(width=width, height=height,
                                            **old))
    for a, b in zip((ct.position, ct.tl_pixel, ct.delta_u, ct.delta_v),
                    (cj.position, cj.tl_pixel, cj.delta_u, cj.delta_v)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ht, wt = warp.gather_history(
        width, height, torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(d)), torch.from_numpy(depth),
        torch.from_numpy(accum), torch.from_numpy(wpix), cap, ct.position,
        ct.tl_pixel, ct.delta_u, ct.delta_v)
    return (ht, wt), (np.array(hj), np.array(wj))


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_history_matches_jax(case):
    width, height, new, old, seed = GATHER_CASES[case]
    n = width * height
    # old view 1: each pixel packs to (j << 5) | 31, so hist names the
    # source pixel each side read and w > 0 exactly where it is valid
    accum, wpix = (x.numpy() for x in index_history(n))
    np.testing.assert_array_equal(
        np.asarray(jrd._pack_history_body(jnp.asarray(accum),
                                          jnp.asarray(wpix), None,
                                          jnp.float32(31.0))),
        (np.arange(n, dtype=np.int32) << 5) | 31)
    (ht, wt), (hj, wj) = _gather_pair(width, height, new, old, seed, accum,
                                      wpix, 31.0)
    it = source_pixels(ht, wt).numpy()
    jidx = source_pixels(torch.from_numpy(hj), torch.from_numpy(wj)).numpy()
    same = it == jidx
    assert same.mean() >= 0.999
    assert 0.7 < (it >= 0).mean() <= 0.8      # the misses are not valid
    # old view 2: random accumulation past HIST_MAX, weights 0-40, cap 8
    rng = np.random.default_rng(seed + 100)
    accum = rng.uniform(-0.5, 10.0, (n, 3)).astype(np.float32)
    wpix = rng.integers(0, 40, n).astype(np.float32)
    (ht, wt), (hj, wj) = _gather_pair(width, height, new, old, seed, accum,
                                      wpix, 8.0)
    ht, wt = ht.numpy(), wt.numpy()
    live = same & (it >= 0)
    np.testing.assert_array_equal(ht[live], hj[live])
    if old:
        rel = np.abs(wt - wj)[same] / np.maximum(wj[same], 1e-30)
        assert rel.max() <= 1e-3
    else:
        np.testing.assert_array_equal(wt[same], wj[same])
        np.testing.assert_array_equal((ht * wt[:, None])[same],
                                      (hj * wj[:, None])[same])
    assert not wt[it < 0].any() and not ht[it < 0].any()


def test_source_pixels_reads_the_index_plane():
    """index_history / source_pixels, which the gather checks read the
    source pixel through: with the camera unmoved, a ray through each
    pixel's centre gathers that pixel; a miss gathers nothing."""
    width, height = 40, 24
    n = width * height
    cam = tcam.build_camera(rtt.CameraConfig(width=width, height=height,
                                             position=(0.3, -0.2, 1.0),
                                             y_rot=0.4))
    i = torch.arange(n)
    centre = tcam.pixel_to_world(cam, i % width + 0.5, i // width + 0.5)
    d = centre - torch.from_numpy(cam.position)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    o = torch.from_numpy(cam.position).expand(n, 3).contiguous()
    depth = torch.from_numpy(np.random.default_rng(5).uniform(
        1, 5, n).astype(np.float32))
    depth[::7] = 1e30
    hist, w = warp.gather_history(width, height, o, d, depth,
                                  *index_history(n), 31.0, cam.position,
                                  cam.tl_pixel, cam.delta_u, cam.delta_v)
    want = torch.where(depth < 1e29, i.to(torch.int32), -1)
    assert torch.equal(source_pixels(hist, w), want)


def test_gather_history_rejects_bad_inputs():
    z3 = torch.zeros(6, 3)
    z = torch.zeros(6)
    basis = [np.zeros(3, np.float32)] * 4
    for args in ((z3[:5], z3, z, z3, z), (z3, z3, z.double(), z3, z),
                 (z3, z3, z, z3[:, :2], z), (z3, z3, z, z3, z.int()),
                 (z3, z3.to("meta"), z, z3, z)):
        with pytest.raises(ValueError):
            warp.gather_history(3, 2, *args, 8.0, *basis)


# -- the slice: the temporal Renderer ---------------------------------------

W, H = 64, 32
MOVES = (None, None, dict(position=(0.0, 0.0, 0.05)), None,
         dict(position=(0.0, 0.0, 0.05), y_rot=0.03), None, None)
PIXEL_ABS = 1e-4
PIXEL_SHARE_MIN = 0.96
MEAN_ABS_MAX = 3e-3
WEIGHT_SHARE_MIN = 0.99


def _settings(pkg, sky):
    return pkg.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                              pixpack=2).with_sky(sky)


def _jax_flythrough():
    """The temporal steps of renderer.py:344-455 composed from JAX's own
    functions, scanline order, interpret-mode megakernel; yields (accum,
    wpix, depth) after each frame."""
    scene, sky = rt.build_scene(1)
    settings = _settings(rt, sky)
    order = np.arange(W * H, dtype=np.int32)
    base = jax.random.key(0)
    accum = jnp.zeros((W * H, 3), jnp.float32)
    wpix = jnp.zeros(W * H, jnp.float32)
    cam, stash, rng_frame = rt.CameraConfig(width=W, height=H), None, 0
    for move in MOVES:
        if move is not None:
            if stash is None:
                stash = (accum, wpix, jcam.build_camera(cam))
                accum = jnp.zeros_like(accum)
                wpix = jnp.zeros_like(wpix)
            cam = dataclasses.replace(cam, **move)
            continue
        o, d = jcam.primary_rays(jcam.build_camera(cam), W, H,
                                 pixel_order=order)
        fkey = jrng.frame_key(base, jnp.int32(rng_frame))
        rng_frame += 1
        mean, _, depth = jmk.render_sample_mean_mega(
            scene, settings, o.T, d.T, fkey, want_depth=True, pixpack=2)
        if stash is not None:
            old_accum, old_wpix, old = stash
            stash = None
            packed = jrd._pack_history_body(old_accum, old_wpix, None,
                                            jnp.float32(8.0))
            hist, w = jrd._gather_history(
                W, H, jnp.asarray(order), o, d, depth, packed, old.position,
                old.tl_pixel, old.delta_u, old.delta_v)
        else:
            hist, w = accum, wpix
        wcol = w[:, None]
        accum = (mean.T + hist * wcol) / (wcol + 1.0)
        wpix = w + 1.0
        yield np.asarray(accum), np.asarray(wpix), np.asarray(depth)


def _port_flythrough():
    scene, sky = rtt.build_scene(1, device="cpu")
    cam = rtt.CameraConfig(width=W, height=H)
    r = rtt.Renderer(scene, cam, _settings(rtt, sky), seed=0, temporal=True,
                     device="cpu")
    for move in MOVES:
        if move is not None:
            r.move_camera(dataclasses.replace(cam, **move))
            continue
        r.render_frame(block=True)
        yield r


def test_temporal_renderer_matches_composed_jax():
    frames = 0
    for r, (ja, jw, jd) in zip(_port_flythrough(), _jax_flythrough()):
        frames += 1
        assert r.settings.pixpack == 2 and r._mega is not None
        err = np.abs(r.accum.numpy() - ja)
        assert (err.max(axis=1) <= PIXEL_ABS).mean() >= PIXEL_SHARE_MIN
        assert err.mean() <= MEAN_ABS_MAX
        tw = r._wpix.numpy()
        assert (tw == jw).mean() >= WEIGHT_SHARE_MIN
        np.testing.assert_array_equal(r._depth.numpy() < 1e29, jd < 1e29)
        if frames == 3:       # the first frame after the dolly
            hits = jd < 1e29
            assert (tw > 1).mean() > 0.5 and (jw > 1).mean() > 0.5
            assert (tw[hits] > 1).all()
    assert frames == 5 and r.frame_num == 2
    r.check_health()
    assert r.image().shape == (H, W, 3)


def _small_temporal(**kw):
    scene, sky = rtt.build_scene(1, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=2,
                           **kw).with_sky(sky)
    return rtt.Renderer(scene, rtt.CameraConfig(width=32, height=16), s,
                        seed=0, temporal=True, device="cpu")


def test_move_before_any_frame_restarts():
    r = _small_temporal()
    cam = dataclasses.replace(r.camera_cfg, position=(0.0, 0.0, 0.1))
    r.move_camera(cam)
    assert r._warp_src is None and r.camera_cfg == cam
    r.render_frame(block=True)
    assert (r._wpix == 1).all()
    # and with reproject=False after a frame
    r.move_camera(dataclasses.replace(cam, y_rot=0.1), reproject=False)
    assert r._warp_src is None and r.frame_num == 0
    assert not r.accum.any() and not r._wpix.any()
    with pytest.raises(ValueError, match="film size"):
        r.move_camera(dataclasses.replace(cam, width=16))


def test_repeated_moves_warp_from_last_rendered_view():
    """Two moves before a frame warp from the last rendered view, which
    is the same as one move straight to the second pose."""
    a, b = _small_temporal(), _small_temporal()
    for r in (a, b):
        r.render_frames(2)
    base = a.camera_cfg
    a.move_camera(dataclasses.replace(base, position=(0.0, 0.0, 0.3)))
    stash = a._warp_src
    a.move_camera(dataclasses.replace(base, position=(0.0, 0.0, 0.1),
                                      y_rot=0.02))
    assert a._warp_src is stash
    b.move_camera(dataclasses.replace(base, position=(0.0, 0.0, 0.1),
                                      y_rot=0.02))
    a.render_frame(block=True)
    b.render_frame(block=True)
    assert torch.equal(a.accum, b.accum) and torch.equal(a._wpix, b._wpix)
    assert (a._wpix > 1).any()


def test_render_frames_runs_the_temporal_step():
    """ROADMAP F5: the port's render_frames in temporal mode is the
    temporal step once per frame (per-pixel weights, the monotonic RNG
    frame), the same as render_frame n times, also across a move, and
    never fused. The JAX package's sequential loop runs its non-temporal
    step there, which blends by frame count and leaves the weights."""
    a, b = _small_temporal(), _small_temporal()
    rec = a.render_frames(2, fuse=True)
    for _ in range(2):
        b.render_frame()
    assert rec["frames"] == 2 and a._rng_frame == 2 == b._rng_frame
    assert torch.equal(a.accum, b.accum) and (a._wpix == 2).all()
    cam = dataclasses.replace(a.camera_cfg, position=(0.0, 0.0, 0.1))
    for r in (a, b):
        r.move_camera(cam)
    a.render_frames(2)
    b.render_frame()
    b.render_frame()
    assert torch.equal(a.accum, b.accum) and torch.equal(a._wpix, b._wpix)
    assert a.frame_num == 2 and (a._wpix > 2).any()


def test_wavefront_sampler_temporal_renders_megakernel():
    """The temporal step renders through the megakernel whatever the
    sampler (renderer.py:363, 379)."""
    r = _small_temporal(sampler="regen")
    assert r._mega is not None and r._wave is None
    r.render_frame(block=True)
    assert (r._wpix == 1).all() and r._depth is not None


# -- the kernel's C interface -----------------------------------------------

CSRC = pathlib.Path(warp.__file__).resolve().parents[1] / "csrc"


def _c_struct_fields(src: str, name: str) -> list:
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        for part in decl.strip().split(",") if decl.strip() else ():
            names.append(re.sub(r"\[\d+\]", "", part.split()[-1].lstrip("*")))
    return names


def test_warp_source_and_binding_without_nvcc():
    from raytracer_tpu_torch.kernels import build
    src = (CSRC / "warp.cu").read_text()
    assert "warp.cu" in build.SOURCES
    assert re.search(r"\bint rt_warp_gather\(", src)
    assert _c_struct_fields(src, "RtWarpGatherArgs") == [
        f[0] for f in build.WarpGatherArgs._fields_]
