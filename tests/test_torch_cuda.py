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
from raytracer_tpu_torch.models.materials import Material, Texture
from raytracer_tpu_torch.models.scene import SceneBuilder
from raytracer_tpu_torch.models.scenes import procedural_earth_texture
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


def test_fetch_image_kernel_matches_plain(dev):
    """rt_fetch_image (K4) is bitwise the plain fetch: two images of 1, 2
    and 4 column blocks, a const material, UVs past [0, 1], NaN and
    infinities."""
    b = SceneBuilder()
    for k, img in enumerate((procedural_earth_texture(50),      # 50x100
                             procedural_earth_texture(96)[:, :129],
                             procedural_earth_texture(256))):   # 256x512
        b.add_sphere((k, 0, 3), 0.5, Material.standard(
            Texture.from_image(img), 0))
    b.add_sphere((0, 2, 3), 0.5, Material.default())
    ms = tmk.MegaScene(b.build(device=dev))
    g = np.random.default_rng(7)
    n = 1 << 16
    u = g.uniform(-0.1, 1.1, n).astype(np.float32)
    v = g.uniform(-0.1, 1.1, n).astype(np.float32)
    u[:5] = [np.nan, np.inf, -np.inf, 1e9, 1.0]
    v[5:10] = [np.nan, np.inf, -np.inf, 1e9, 1.0]
    mid = g.integers(0, ms.mat.shape[1] + 1, n).astype(np.int32)
    u, v, mid = (torch.as_tensor(x, device=dev) for x in (u, v, mid))
    before = tmk.FETCH_LAUNCHES
    got = tmk.fetch_image(ms, u, v, mid)
    torch.cuda.synchronize()
    assert tmk.FETCH_LAUNCHES == before + 1
    m = ms.mat[:, mid.long().clamp(0, ms.mat.shape[1] - 1)]
    want = torch.stack(tmk.fetch_image_reference(
        ms.tex, ms.img_rows, u, v, m[tmk._M_TW], m[tmk._M_TH],
        m[tmk._M_TROW]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("num", [4, 2])
@pytest.mark.parametrize("pixpack", [1, 8])
def test_megakernel_matches_plain(dev, pixpack, num):
    """Scene 4 and scene 2 (the image-textured earth: K4 inside K1)."""
    scene, sky = rtt.build_scene(num, seed=0, device=dev) if num == 4 else \
        rtt.build_scene(num, device=dev)
    ms = tmk.MegaScene(scene)
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5).with_sky(sky)
    o, d = _rays(dev)
    key = trng.fold_in(trng.key(0), 1)
    before = (tmk.LAUNCHES, tmk.IMAGE_LAUNCHES)
    mean, segs, depth = tmk.render_sample_mean_mega(
        ms, s, o, d, key, want_depth=True, pixpack=pixpack)
    torch.cuda.synchronize()
    assert (tmk.LAUNCHES, tmk.IMAGE_LAUNCHES) == (
        before[0] + 1, before[1] + int(num == 2))
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


# -- the wavefront samplers' kernels: rt_lane_randoms, K5, K6 ---------------

def _field_scene(dev, n_sph=6000, n_tri=40, seed=3):
    """Random spheres, a few textured triangles and a one-way quad: more
    than one 4096-sphere block, so K6 pops and merges several blocks."""
    g = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_spheres(g.uniform(-10, 10, (n_sph, 3)), g.uniform(0.1, 0.4, n_sph),
                  Material.standard(Texture.const_colour((1, 1, 1)), 0.3),
                  colours=g.uniform(0, 1, (n_sph, 3)))
    white = Material.standard(Texture.checkerboard((1, 1, 1), (0, 0, 0), 4),
                              0)
    for _ in range(n_tri):
        p = g.uniform(-10, 10, 3)
        b.add_triangle(p, p + g.uniform(-1, 1, 3), p + g.uniform(-1, 1, 3),
                       white, uvs=((0, 0), (1, 0), (0, 1)))
    # a one-way quad: the kernels read the triangles' cull rows too
    b.add_one_way_quad((-8, -8, 0), (8, -8, 0), (8, 8, 0), (-8, 8, 0),
                       False, white)
    scene = b.build(device=dev)
    assert scene.has_one_way and scene.needs_tri_uv
    return scene


def _field_rays(dev, n, seed=4):
    g = np.random.default_rng(seed)
    o = g.uniform(-10, 10, (3, n)).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def test_lane_randoms_kernel_matches_plain(dev):
    """rt_lane_randoms: key folds and uniforms bitwise, normals too (the
    same float32 operations and CUDA's log1pf on both sides)."""
    from raytracer_tpu_torch.ops import rng
    n = 1 << 16
    g = np.random.default_rng(9)
    keys = rng.per_ray_keys(rng.key(5), torch.arange(n, device=dev))
    s = torch.as_tensor(g.integers(0, 64, n).astype(np.int32), device=dev)
    b = torch.as_tensor(g.integers(0, 6, n).astype(np.int32), device=dev)
    for sample, rr in ((s, False), (s, True), (None, False)):
        before = rng.LAUNCHES
        got = rng.lane_randoms(keys, sample, b, with_rr=rr)
        torch.cuda.synchronize()
        assert rng.LAUNCHES == before + 1
        want = rng.lane_randoms_reference(keys, sample, b, with_rr=rr)
        got = torch.cat([got[0], got[1], got[2][None]] +
                        ([got[3][None]] if rr else []))
        uni = [0, 1, 2, 6] + ([7] if rr else [])
        assert torch.equal(got[uni], want[uni])
        assert torch.equal(got[3:6], want[3:6])


def _k5_k6_agree(got, want, code_mismatch_max=1e-4):
    same = got[1] == want[1]
    assert float((~same).float().mean()) <= code_mismatch_max
    t_g, t_w = got[0][same], want[0][same]
    assert float(((t_g - t_w).abs() / t_w.abs().clamp(min=1.0)).max()) \
        <= 1e-5
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[same], b[same])


def test_hit_resolve_kernel_matches_plain(dev):
    """K5 (rt_hit_resolve) against its plain version on scene 4 and on a
    textured triangle scene."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    for scene in (rtt.build_scene(4, seed=0, device=dev)[0],
                  _field_scene(dev, n_sph=300)):
        ws = ic.WaveScene(scene, blocked=False)
        o, d = _field_rays(dev, 1 << 15)
        before = ic.LAUNCHES
        got = ic.hit_resolve_unit(ws, o, d)
        torch.cuda.synchronize()
        assert ic.LAUNCHES == before + 1
        _k5_k6_agree(got, ic.hit_resolve_unit(ws, o, d, plain=True))


def test_hit_resolve_blocked_kernel_matches_plain(dev):
    """K6 (rt_hit_resolve_blocked) against plain K6 on two sphere blocks,
    and against K5 on the same rays: only exact ties may differ."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene = _field_scene(dev)
    wb = ic.WaveScene(scene, blocked=True)
    assert wb.tables.nblocks == 2
    o, d = _field_rays(dev, 1 << 15)
    before = ic.BLOCKED_LAUNCHES
    got = ic.hit_resolve_unit(wb, o, d)
    torch.cuda.synchronize()
    assert ic.BLOCKED_LAUNCHES == before + 1
    _k5_k6_agree(got, ic.hit_resolve_unit(wb, o, d, plain=True))
    k5 = ic.hit_resolve_unit(ic.WaveScene(scene, blocked=False), o, d)
    differ = got[1] != k5[1]
    assert torch.equal(got[0][differ], k5[0][differ])


@pytest.mark.parametrize("sampler", ["regen", "scan", "rebin", "lanesort"])
def test_wavefront_frame_matches_plain_route(dev, sampler):
    """One small frame of each wavefront sampler through a Renderer on the
    card (K5 and the lane randoms launched) against the plain route (every
    kernel replaced by its plain version) on the same rays and key."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import integrator as tint
    scene, sky = rtt.build_scene(4, seed=0)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                           sampler=sampler).with_sky(sky)
    cam = rtt.CameraConfig(width=64, height=32, position=(0.0, 0.5, -6.0))
    r = rtt.Renderer(scene, cam, s, device=dev)
    before = (ic.LAUNCHES, trng.LAUNCHES)
    r.render_frame(block=True)
    assert ic.LAUNCHES > before[0] and trng.LAUNCHES > before[1]
    assert r.accum.device.type == "cuda"
    ref, ref_segs = tint.render_sample_mean(
        r.packed_scene, s, r._o, r._d, trng.frame_key(r.base_key, 0),
        ray_idx=r._ray_idx, backend="plain")
    err = (r.accum - ref).abs().amax(dim=1)
    assert float((err <= PIXEL_ABS).float().mean()) >= PIXEL_SHARE_MIN
    assert abs(r.total_segments - float(ref_segs)) <= \
        SEGS_REL * float(ref_segs)
