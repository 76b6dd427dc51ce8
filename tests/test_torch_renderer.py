"""raytracer_tpu_torch Renderer: progressive frames against an accumulator
built by hand from raytracer_tpu's megakernel (interpret mode), the Morton
order of image(), checkpoint/resume, device policy and the jax-free import.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.ops import film as jfilm
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu_torch.ops import integrator as tint
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.parallel.mesh import Mesh, Sharding

torch.set_num_threads(2)

# per-pixel bounds as in test_torch_megakernel.py (64x64, pixpack 1)
PIXEL_ABS = 1e-4
PIXEL_SHARE_MIN = 0.96
MEAN_ABS_MAX = 3e-3


def _port_renderer(width=64, height=64, spp=2, **kw):
    scene, sky = rtt.build_scene(4, seed=0, device="cpu")
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                  antialias=True, **kw).with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height)
    return rtt.Renderer(scene, cam, settings, seed=0, device="cpu")


def test_renderer_matches_jax_accumulator():
    r = _port_renderer(pixpack=1)
    for _ in range(2):
        r.render_frame(block=True)
    assert r.frame_num == 2 and len(r.stats_log) == 2

    js, sky = rt.build_scene(4, seed=0)
    settings = rt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                                 antialias=True, pixpack=1).with_sky(sky)
    order = jcam.morton_order(64, 64)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=64, height=64)), 64, 64,
        pixel_order=order)
    np.testing.assert_array_equal(np.asarray(o), r._o.numpy())
    np.testing.assert_array_equal(np.asarray(d), r._d.numpy())
    accum = jnp.zeros((64 * 64, 3), jnp.float32)
    base = jax.random.key(0)
    for frame in range(2):
        fkey = jrng.frame_key(base, frame)
        mean, _ = jmk.render_sample_mean_mega(js, settings, o.T, d.T, fkey)
        fn = jnp.float32(frame)
        accum = (mean.T + accum * fn) / (fn + 1.0)   # integrator.py:461-462
    err = np.abs(r.accum.numpy() - np.asarray(accum))
    assert (err.max(axis=1) <= PIXEL_ABS).mean() >= PIXEL_SHARE_MIN
    assert err.mean() <= MEAN_ABS_MAX


@pytest.mark.parametrize("gamma", [None, 2.2])
def test_image_undoes_morton_like_jax(gamma, tmp_path):
    w, h = 37, 23
    scene, _ = rtt.build_scene(4, seed=0, device="cpu")
    settings = rtt.RenderSettings(rays_per_pixel=1, gamma=gamma)
    r = rtt.Renderer(scene, rtt.CameraConfig(width=w, height=h), settings,
                     device="cpu")
    g = np.random.default_rng(0)
    acc = g.uniform(0, 1.2, (w * h, 3)).astype(np.float32)
    r.accum.copy_(torch.from_numpy(acc))
    flat = np.empty_like(acc)
    flat[jcam.morton_order(w, h)] = acc     # as raytracer_tpu's image()
    want = jfilm.to_u8(flat, w, h, gamma=gamma)
    np.testing.assert_array_equal(r.image(), want)
    assert r.image().shape == (h, w, 3)
    from PIL import Image
    r.save_png(str(tmp_path / "out.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "out.png")), want)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    r = _port_renderer(32, 32, spp=1)
    r.render_frames(2)
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r2 = rtt.Renderer(r.scene, r.camera_cfg, r.settings, seed=99,
                      device="cpu")
    r2.load_checkpoint(path)
    assert r2.frame_num == 2
    np.testing.assert_array_equal(r2.base_key, r.base_key)
    assert r2.total_segments == r.total_segments
    r.render_frame(block=True)
    r2.render_frame(block=True)
    assert torch.equal(r.accum, r2.accum)
    with np.load(path) as data:   # the JAX checkpoint's keys and types
        assert set(data.files) == {"accum", "frame_num", "key_data",
                                   "total_segments"}
        assert data["key_data"].dtype == np.uint32


def test_frames_stats_and_fuse(tmp_path):
    r = _port_renderer(32, 32, spp=1)
    assert r.settings.pixpack == 8            # auto policy at spp <= 32
    rec = r.render_frames(2)
    assert rec["frames"] == 2 and rec["segments"] > 0
    assert rec["mrays_per_sec"] > 0 and np.isfinite(rec["frame_ms"])
    fused = _port_renderer(32, 32, spp=1)
    fused.render_frames(2, fuse=True)
    assert fused.frame_num == 2
    fused.check_health()
    # fused = one launch of 2 spp under frame 0's key
    batch = dataclasses.replace(fused.settings, rays_per_pixel=2)
    mean, _ = tint.render_sample_mean(fused._mega, batch, fused._o,
                                      fused._d,
                                      trng.frame_key(fused.base_key, 0))
    torch.testing.assert_close(fused.accum, mean, rtol=1e-6, atol=1e-6)
    path = str(tmp_path / "stats.jsonl")
    r.write_stats(path)
    lines = [json.loads(x) for x in open(path)]
    assert len(lines) == 1 and lines[0]["frames"] == 2
    assert not r.stats_log
    assert _port_renderer(32, 32, spp=64).settings.pixpack == 1
    r.accum[0, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        r.check_health()


def test_device_policy_and_unported_modes(monkeypatch):
    scene, _ = rtt.build_scene(4, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rtt.Renderer(scene, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rtt.Renderer(scene)                   # the card is the default
    with pytest.raises(NotImplementedError, match="not to be ported"):
        rtt.Renderer(scene, adaptive_order=True)
    # sharding (ROADMAP item 10, now ported) needs an initialised process
    # group, and temporal mode renders on one device
    no_group = Sharding(Mesh(("px",), (2,), (0,), None, (None,), 0), "px")
    with pytest.raises(RuntimeError, match="initialised process group"):
        rtt.Renderer(scene, device="cpu", sharding=no_group)
    with pytest.raises(ValueError, match="one device"):
        rtt.Renderer(scene, device="cpu", sharding=no_group, temporal=True)


def test_import_leaves_jax_out():
    code = ("import sys, raytracer_tpu_torch\n"
            "import raytracer_tpu_torch.kernels.build\n"
            "import raytracer_tpu_torch.models.bench_scenes\n"
            "import raytracer_tpu_torch.models.obj_loader\n"
            "import raytracer_tpu_torch.runtime.loader\n"
            "import raytracer_tpu_torch.utils.image\n"
            "import raytracer_tpu_torch.utils.debug\n"
            "import raytracer_tpu_torch.ops.warp\n"
            "import raytracer_tpu_torch.runtime.interactive\n"
            "import raytracer_tpu_torch.runtime.viewer\n"
            "import raytracer_tpu_torch.__main__\n"
            "raytracer_tpu_torch.build_scene(0, device='cpu')\n"
            "raytracer_tpu_torch.build_scene(2, device='cpu')\n"
            "assert 'pygame' not in sys.modules\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'raytracer_tpu.')) or m == 'raytracer_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
