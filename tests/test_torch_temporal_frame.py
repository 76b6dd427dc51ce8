"""raytracer_tpu_torch's temporal frame as JAX's temporal step runs it, on
the CPU: the padded camera rays (``camera_rays``, ``rt_camera_rays``) and
the epilogue after the megakernel (``warp.temporal_frame``,
``rt_temporal_frame``).

- ``camera_rays_reference`` is ``pad_rays`` over the scanline
  ``primary_rays``, bitwise, at 64x48 and 130x70, pixpack 1 and 8 (frames
  that are not whole tiles, and smaller than one); against JAX's
  ``primary_rays`` with megakernel.py:1189-1202's pad and rsqrt it is
  bitwise on ``o``, the pad lanes and the first normalisation, and the
  rsqrt'd direction is within RSQRT_ULPS (ROADMAP F2: XLA's CPU rsqrt
  rounds otherwise than torch's on ~29% of values).
- ``temporal_frame_reference``, both arms, bitwise with a frozen copy of
  the composition the temporal Renderer ran before (the rays from
  ``primary_rays``, ``gather_history`` after a move, then
  ``film.temporal_update``).
- A temporal CPU Renderer through frame, move, frame, two moves, frame,
  bitwise with a frozen copy of the Renderer's temporal steps of before;
  the state a move leaves visible (the zero film, no depth, the rays built
  at the next frame, nothing filled a move).
- The new C structs against build.py's ctypes; the wrappers' checks.

tests/test_torch_temporal.py holds the temporal Renderer against the
composed JAX steps; the kernels are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 13).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu_torch.models import camera as tcam
from raytracer_tpu_torch.ops import film, warp
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.runtime.renderer import Renderer
from raytracer_tpu_torch.utils import trace
from test_torch_megakernel import CSRC, _c_struct_fields

torch.set_num_threads(2)

# (width, height, pixpack): 3072 and 9100 pixels against tiles of 4096 *
# pixpack lanes
FILMS = [(64, 48, 1), (64, 48, 8), (130, 70, 1), (130, 70, 8)]
# the rsqrt'd direction against JAX's, in units in the last place
RSQRT_ULPS = 2


def _camera(width, height, **pose):
    """A camera of the 4K fly-through's path (chip_smoke.py fly_camera),
    at this film size."""
    pose = pose or dict(position=(0.0, 0.5, -5.75), y_rot=0.02)
    return rtt.CameraConfig(width=width, height=height, **pose)


def _ulps(a, b):
    """|a - b| in units in the last place of the larger of the two."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    big = np.maximum(np.abs(a), np.abs(b))
    return np.abs(a.astype(np.float64) - b) / np.spacing(big)


# -- rt_camera_rays' plain version ----------------------------------------

@pytest.mark.parametrize("width,height,pixpack", FILMS)
def test_camera_rays_reference_is_pad_rays_of_primary_rays(width, height,
                                                           pixpack):
    cam = tcam.build_camera(_camera(width, height))
    got = tcam.camera_rays_reference(cam, width, height, pixpack, "cpu")
    o, d = tcam.primary_rays(cam, width, height, device="cpu")
    o_p, d_p = tmk.pad_rays(o.T, d.T, pixpack)
    assert torch.equal(got.o, o_p) and torch.equal(got.d, d_p)
    tile = tmk.MEGA_TILE * pixpack
    assert (got.n, got.pixpack) == (width * height, pixpack)
    assert got.o.shape == got.d.shape == (3, -(-width * height // tile)
                                          * tile)
    before = trace.counts()
    wrapped = tcam.camera_rays(cam, width, height, pixpack, device="cpu")
    assert torch.equal(wrapped.o, got.o) and torch.equal(wrapped.d, got.d)
    assert trace.counts() == before       # CPU tensors launch nothing


def _jax_padded_rays(cfg, pixpack):
    """JAX's temporal step's rays: primary_rays in scanline order
    (renderer.py:362), then megakernel.py:1189-1202's pad and rsqrt."""
    n = cfg.width * cfg.height
    o, d = jcam.primary_rays(jcam.build_camera(cfg), cfg.width, cfg.height,
                             pixel_order=np.arange(n, dtype=np.int32))
    first = np.asarray(d)
    o, d = o.T, d.T
    tile = tmk.MEGA_TILE * pixpack
    n_pad = max(tile, ((n + tile - 1) // tile) * tile)
    if n_pad != n:
        pad_o = jnp.zeros((3, n_pad - n), o.dtype)
        pad_d = jnp.zeros((3, n_pad - n), d.dtype).at[0].set(1.0)
        o = jnp.concatenate([o, pad_o], axis=1)
        d = jnp.concatenate([d, pad_d], axis=1)
    d = d * jax.lax.rsqrt(jnp.sum(d * d, axis=0))[None, :]
    return np.asarray(o), np.asarray(d), first


@pytest.mark.parametrize("width,height,pixpack", FILMS)
def test_camera_rays_reference_against_jax(width, height, pixpack):
    pose = dict(position=(0.1, 0.45, -5.5), x_rot=0.03, y_rot=0.05)
    jo, jd, jfirst = _jax_padded_rays(
        rt.CameraConfig(width=width, height=height, **pose), pixpack)
    cfg = rtt.CameraConfig(width=width, height=height, **pose)
    cam = tcam.build_camera(cfg)
    got = tcam.camera_rays_reference(cam, width, height, pixpack, "cpu")
    n = width * height
    np.testing.assert_array_equal(got.o.numpy(), jo)
    # the first normalisation: the rays the warp arm gathers with
    _, d = tcam.primary_rays(cam, width, height, device="cpu")
    np.testing.assert_array_equal(d.numpy(), jfirst)
    # the pad lanes
    np.testing.assert_array_equal(got.d[:, n:].numpy(), jd[:, n:])
    assert (got.d[0, n:] == 1).all() and not got.d[1:, n:].any()
    assert _ulps(got.d[:, :n].numpy(), jd[:, :n]).max() <= RSQRT_ULPS


def test_camera_rays_rejects_bad_arguments():
    cam = tcam.build_camera(_camera(8, 4))
    for args in ((8, 4, 0), (0, 4, 1), (8, 0, 8)):
        with pytest.raises(ValueError):
            tcam.camera_rays(cam, *args, device="cpu")


def test_megakernel_takes_padded_rays_as_they_are():
    """render_sample_mean_mega over the padded rays is bitwise the route
    over (3, N) rays, whose padding and rsqrt the record already holds;
    a record of another pixpack, or with d given too, is refused."""
    scene, sky = rtt.build_scene(1, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=2,
                           pixpack=2).with_sky(sky)
    ms = tmk.MegaScene(scene)
    cam = tcam.build_camera(_camera(40, 30))
    o, d = tcam.primary_rays(cam, 40, 30, device="cpu")
    key = trng.frame_key(trng.key(0), 3)
    want = tmk.render_sample_mean_mega(ms, s, o.T, d.T, key,
                                       want_depth=True)
    rays = tcam.camera_rays(cam, 40, 30, 2, device="cpu")
    got = tmk.render_sample_mean_mega(ms, s, rays, None, key,
                                      want_depth=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pixpack"):
        tmk.render_sample_mean_mega(
            ms, s, tcam.camera_rays(cam, 40, 30, 1, device="cpu"), None, key)
    with pytest.raises(ValueError):
        tmk.render_sample_mean_mega(ms, s, rays, d.T, key)


# -- rt_temporal_frame's plain version ------------------------------------

def _todays_epilogue(width, height, cam, mean, depth, accum, wpix,
                     stash=None):
    """The temporal Renderer's steps after the megakernel as composed
    before ``temporal_frame`` (a frozen copy): the blend over this view,
    or after a move the rays of ``cam`` from ``primary_rays``, the stash
    (old accumulation, weights, cap, old camera) gathered by
    ``gather_history`` and then the blend."""
    if stash is None:
        hist, w = accum, wpix
    else:
        old_accum, old_wpix, cap, old = stash
        o, d = tcam.primary_rays(cam, width, height, device="cpu")
        hist, w = warp.gather_history(
            width, height, o, d, depth, old_accum, old_wpix, cap,
            old.position, old.tl_pixel, old.delta_u, old.delta_v)
    return film.temporal_update(hist, mean.T, w)


def _frame_inputs(width, height, pixpack, seed):
    """K1's (5, n_pad) output (integer segment counts on one pixel in
    eight, as on pixel block 0 at pixpack 8; a fifth of the depths
    missed) and N, an old accumulation past HIST_MAX and weights 0-39."""
    g = np.random.default_rng(seed)
    n = width * height
    tile = tmk.MEGA_TILE * pixpack
    out = torch.from_numpy(g.uniform(0, 3, (5, -(-n // tile) * tile)).astype(
        np.float32))
    out[3] = torch.from_numpy((g.integers(0, 200, out.shape[1])
                               * (g.uniform(size=out.shape[1]) < 0.125))
                              .astype(np.float32))
    out[4] = torch.from_numpy(g.uniform(0.5, 8.0, out.shape[1]).astype(
        np.float32))
    out[4, : n // 5] = 1e30
    accum = torch.from_numpy(g.uniform(-0.5, 10.0, (n, 3)).astype(
        np.float32))
    wpix = torch.from_numpy(g.integers(0, 40, n).astype(np.float32))
    return out, n, accum, wpix


@pytest.mark.parametrize("width,height,pixpack", FILMS)
@pytest.mark.parametrize("arm", ["static", "warp"])
def test_temporal_frame_reference_is_todays_epilogue(width, height,
                                                     pixpack, arm):
    out, n, accum, wpix = _frame_inputs(width, height, pixpack, 7)
    old = tcam.build_camera(_camera(width, height, position=(0.0, 0.5, -6.0)))
    cam = tcam.build_camera(_camera(width, height))
    if arm == "static":
        src = stash = None
    else:
        src = warp.history_source(accum, wpix, 8.0, old)
        stash = (accum, wpix, 8.0, old)
    want = _todays_epilogue(width, height, cam, out[:3, :n], out[4, :n],
                            accum.clone(), wpix.clone(), stash)
    # the segments as render_sample_mean_mega counted them
    segs = out[3, :n].sum(dtype=torch.float64)
    got = warp.temporal_frame_reference(out, n, accum.clone(), wpix.clone(),
                                        src, cam, width, height)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].dtype == torch.float64 and float(got[2]) == float(segs)
    before = trace.counts()
    a = accum.clone()
    wrapped = warp.temporal_frame(out, n, a, wpix.clone(), src, cam, width,
                                  height)
    assert trace.counts() == before      # CPU tensors launch nothing
    assert torch.equal(wrapped[0], want[0])
    assert torch.equal(wrapped[1], want[1])
    assert float(wrapped[2]) == float(segs)
    # the static arm blends in place; the warp arm leaves the planes
    assert (wrapped[0] is a) == (arm == "static")
    if arm == "warp":
        assert torch.equal(a, accum)
        assert ((wrapped[1] > 1).float().mean() > 0.3
                and (wrapped[1] == 1).any())


def test_history_source_holds_the_projection_basis():
    cam = tcam.build_camera(_camera(64, 48, position=(0.2, 0.5, -6.0),
                                    x_rot=0.08, z_rot=0.01))
    src = warp.history_source(torch.zeros(3072, 3), torch.zeros(3072), 8,
                              cam)
    nrm, focal, dudu, dvdv = warp.projection_basis(
        cam.position, cam.tl_pixel, cam.delta_u, cam.delta_v)
    np.testing.assert_array_equal(src.nrm, nrm.numpy())
    assert (src.focal, src.dudu, src.dvdv, src.history) == (
        float(focal), float(dudu), float(dvdv), 8.0)
    assert src.cam is cam


def test_temporal_frame_rejects_bad_inputs():
    out, n, accum, wpix = _frame_inputs(8, 4, 1, 3)
    cam = tcam.build_camera(_camera(8, 4))
    src = warp.history_source(accum, wpix, 8.0, cam)
    bad = [(out[:4], n, accum, wpix),
           (out[:, :n - 1], n, accum, wpix),
           (out.T.contiguous().T, n, accum, wpix),
           (out.double(), n, accum, wpix),
           (out, n, accum.double(), wpix),
           (out, n, accum, wpix[:, None]),
           (out, n, accum, wpix.to("meta")),
           (out, n, accum, wpix, src),                   # no camera
           (out, n, accum, wpix, src, cam, 4, 8 + 1)]    # film size
    for args in bad:
        with pytest.raises(ValueError):
            warp.temporal_frame(*args)


# -- the temporal Renderer ------------------------------------------------

class _TodaysTemporal(Renderer):
    """The temporal Renderer's camera and frame steps as they were before
    the frame ran through ``camera_rays`` and ``temporal_frame`` (a frozen
    copy): rays from ``primary_rays`` at every camera set, a fresh zero
    film a move, the megakernel over (3, N) rays, ``gather_history`` after
    a move, then ``film.temporal_update``."""

    def _set_rays(self, camera):
        self.camera_cfg = camera
        self._o, self._d = tcam.primary_rays(
            tcam.build_camera(camera), camera.width, camera.height,
            device=self.device)

    def move_camera(self, camera, reproject=True, history=8.0):
        rendered = self.frame_num > 0 or self._warp_src is not None
        if not (reproject and rendered):
            self._depth = None
            self._warp_src = None
            self.set_camera(camera)
            return
        if self._warp_src is None:
            self._warp_src = (self.accum, self._wpix, float(history),
                              tcam.build_camera(self.camera_cfg))
            self._wpix = torch.zeros_like(self._wpix)
            self.accum = film.new_accumulator(self.camera_cfg.num_pixels,
                                              self.device)
        self._depth = None
        self._set_rays(camera)
        self.frame_num = 0

    def _temporal_render(self):
        fkey = trng.frame_key(self.base_key, self._rng_frame)
        self._rng_frame += 1
        mean, segs, depth = tmk.render_sample_mean_mega(
            self._mega, self.settings, self._o.T, self._d.T, fkey,
            want_depth=True)
        cam = self.camera_cfg
        stash, self._warp_src = self._warp_src, None
        self.accum, self._wpix = _todays_epilogue(
            cam.width, cam.height, tcam.build_camera(cam), mean, depth,
            self.accum, self._wpix, stash)
        self._depth = depth
        return segs


# frame, move, frame, two moves, frame (None: a frame)
STEPS = (None, dict(position=(0.0, 0.0, 0.05)), None,
         dict(position=(0.0, 0.05, 0.1), y_rot=0.02),
         dict(position=(0.02, 0.0, 0.15), y_rot=0.03, x_rot=0.01), None)


@pytest.mark.parametrize("width,height,pixpack", [(64, 48, 8),
                                                  (130, 70, 1)])
def test_temporal_renderer_is_todays(width, height, pixpack):
    scene, sky = rtt.build_scene(1, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=3,
                           pixpack=pixpack).with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height)
    new, old = (cls(scene, cam, s, seed=0, temporal=True, device="cpu")
                for cls in (Renderer, _TodaysTemporal))
    frames = 0
    for step in STEPS:
        if step is not None:
            for r in (new, old):
                r.move_camera(dataclasses.replace(cam, **step))
            continue
        for r in (new, old):
            r.render_frame(block=True)
        frames += 1
        assert torch.equal(new.accum, old.accum)
        assert torch.equal(new._wpix, old._wpix)
        assert torch.equal(new._depth, old._depth)
        assert new.total_segments == old.total_segments
    assert frames == 3 and new._rng_frame == 3
    assert (new._wpix > 1).float().mean() > 0.3


def test_a_move_leaves_the_zero_film_and_builds_rays_at_the_frame(
        tmp_path):
    """After a move, and a second one, the visible state is a zero film
    and no depth until the next frame; the rays are built once, at that
    frame; the zero film is made once and never written (a warp frame
    writes new planes, a checkpoint load copies it first)."""
    scene, sky = rtt.build_scene(1, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=2,
                           pixpack=8).with_sky(sky)
    cam = rtt.CameraConfig(width=32, height=16)
    r = Renderer(scene, cam, s, seed=0, temporal=True, device="cpu")
    assert r._rays is None
    r.render_frame(block=True)
    rays = r._rays
    r.render_frame(block=True)
    assert r._rays is rays                # static frames reuse the rays
    first = r.accum.clone()
    r.move_camera(dataclasses.replace(cam, position=(0.0, 0.0, 0.1)))
    zeros = r.accum, r._wpix
    r.move_camera(dataclasses.replace(cam, position=(0.0, 0.0, 0.2)))
    assert (r.accum, r._wpix) == zeros and r._rays is None
    assert not r.accum.any() and not r._wpix.any() and r._depth is None
    assert not r.image().any() and r._rng_frame == 2
    assert torch.equal(r._warp_src.accum, first)
    r.render_frame(block=True)
    assert r._rays is not None and r.accum is not zeros[0]
    assert r._rng_frame == 3 and (r._wpix > 1).any()
    r.move_camera(dataclasses.replace(cam, position=(0.0, 0.0, 0.3)))
    assert r.accum is zeros[0] and not zeros[0].any()
    other = Renderer(scene, cam, s, seed=0, temporal=True, device="cpu")
    other.render_frame(block=True)
    path = str(tmp_path / "ckpt.npz")
    other.save_checkpoint(path)
    r.load_checkpoint(path)
    assert torch.equal(r.accum, other.accum) and not zeros[0].any()


# -- the kernels' C interface ---------------------------------------------

def test_camera_and_frame_structs_match_ctypes():
    """rt_camera_rays (csrc/camera.cu) and rt_temporal_frame (csrc/warp.cu):
    entry points, argument structs field by field, camera.cu built, the
    camera ray shared from camera.cuh and the gather from warp.cuh."""
    from raytracer_tpu_torch.kernels import build
    assert "camera.cu" in build.SOURCES
    srcs = {name: (CSRC / name).read_text()
            for name in ("camera.cu", "warp.cu", "camera.cuh", "warp.cuh")}
    assert re.search(r"\bint rt_camera_rays\(", srcs["camera.cu"])
    assert re.search(r"\bint rt_temporal_frame\(", srcs["warp.cu"])
    for name, c_name, py in (("camera.cu", "RtCameraRaysArgs",
                              build.CameraRaysArgs),
                             ("warp.cu", "RtTemporalArgs",
                              build.TemporalArgs)):
        assert _c_struct_fields(srcs[name], c_name) == [
            f[0] for f in py._fields_]
    assert '#include "camera.cuh"' in srcs["camera.cu"]
    assert '#include "camera.cuh"' in srcs["warp.cu"]
    assert '#include "warp.cuh"' in srcs["warp.cu"]
    assert re.search(r"__device__[^;{]*\bcamera_ray\(", srcs["camera.cuh"])
    assert re.search(r"__device__[^;{]*\bgather_pixel\(", srcs["warp.cuh"])
    # the temporal frame's warp arm runs the one gather, defined in warp.cuh
    assert len(re.findall(r"\bgather_pixel\(", srcs["warp.cu"])) == 1
    assert not re.search(r"__device__[^;{]*\bgather_pixel\(", srcs["warp.cu"])
