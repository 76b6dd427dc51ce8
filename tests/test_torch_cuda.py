"""raytracer_tpu_torch CUDA kernels against their plain PyTorch versions on
the card. Every test here needs an NVIDIA card and skips without one.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

On the card the kernels and their plain versions evaluate the same IEEE
float32 operations in the same order (the kernels are built without FMA
contraction) and draw the same hash bits, so they are held tightly: a
pixel may differ only where a path runs another way, which the per-thread
cluster gate could cause for a ray that hits a primitive without entering
its padded box.
"""

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.models import camera as tcam
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.ops import sweep as tsweep

PIXEL_ABS = 1e-4
PIXEL_SHARE_MIN = 0.99
SEGS_REL = 5e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rays(dev, width=128, height=64):
    cfg = rtt.CameraConfig(width=width, height=height)
    o, d = tcam.primary_rays(tcam.build_camera(cfg), width, height,
                             pixel_order=tcam.morton_order(width, height),
                             device=dev)
    return o.T.contiguous(), d.T.contiguous()


def test_nearest_hit_kernel_matches_plain(dev):
    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    ps = tsweep.pack(scene)
    g = np.random.default_rng(5)
    n = 1 << 16
    o = np.stack([g.uniform(-6, 6, n), g.uniform(-1.5, 3.0, n),
                  g.uniform(-2, 11, n)]).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    before = tsweep.LAUNCHES
    got = tsweep.nearest_hit(ps, o, d)
    torch.cuda.synchronize()
    assert tsweep.LAUNCHES == before + 1
    want = tsweep.nearest_hit_reference(ps, o, d)
    same = got[1] == want[1]
    assert float((~same).float().mean()) <= 1e-4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a[same], b[same])


@pytest.mark.parametrize("pixpack", [1, 8])
def test_megakernel_matches_plain(dev, pixpack):
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    ms = tmk.MegaScene(scene)
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5).with_sky(sky)
    o, d = _rays(dev)
    key = trng.fold_in(trng.key(0), 1)
    before = tmk.LAUNCHES
    mean, segs, depth = tmk.render_sample_mean_mega(
        ms, s, o, d, key, want_depth=True, pixpack=pixpack)
    torch.cuda.synchronize()
    assert tmk.LAUNCHES == before + 1
    o_p, d_p, seed, kw = tmk.mega_inputs(ms, s, o, d, key, pixpack=pixpack)
    ref = tmk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    n = o.shape[1]
    err = (mean - ref[:3, :n]).abs().amax(dim=0)
    assert float((err <= PIXEL_ABS).float().mean()) >= PIXEL_SHARE_MIN
    ref_segs = float(ref[3, :n].double().sum())
    assert abs(float(segs) - ref_segs) <= SEGS_REL * ref_segs
    assert torch.equal(depth < tmk.INF, ref[4, :n] < tmk.INF)


def test_cuda_renderer_checkpoint_is_bitwise(dev, tmp_path):
    scene, sky = rtt.build_scene(4, seed=0)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5).with_sky(sky)
    cam = rtt.CameraConfig(width=96, height=64)
    r = rtt.Renderer(scene, cam, s, device=dev)
    assert r.accum.device.type == "cuda"
    r.render_frames(2)
    r.check_health()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r2 = rtt.Renderer(scene, cam, s, seed=5, device=dev)
    r2.load_checkpoint(path)
    r.render_frame(block=True)
    r2.render_frame(block=True)
    assert torch.equal(r.accum, r2.accum)
    assert r.image().shape == (64, 96, 3)
