"""raytracer_tpu_torch CUDA kernels against their plain PyTorch versions on
the card. Every test here needs an NVIDIA card and skips without one.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

On the card the kernels and their plain versions evaluate the same IEEE
float32 operations in the same order (the kernels are built without FMA
contraction) and draw the same hash bits, so they are held tightly: a
pixel may differ only where a path runs another way, which the per-thread
cluster gate could cause for a ray that hits a primitive without entering
its padded box. The megakernel, rt_nearest_hit and the wavefront hit
kernels K5 and K6 are held bitwise at every group size G
(``GROUP_CASES``: the rule's G and each forced G), on scenes 4 and 2,
stress10k tiles, a two-block field and the exact-tie scenes of
test_torch_tie_scene.py (K6 on its blocked variant).
"""

import collections
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_tie_scene as tie_scene

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.models import camera as tcam
from raytracer_tpu_torch.models.materials import Material, Texture
from raytracer_tpu_torch.models.scene import SceneBuilder
from raytracer_tpu_torch.models.scenes import procedural_earth_texture
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.ops import sweep as tsweep
from raytracer_tpu_torch.utils import trace

PIXEL_ABS = 1e-4
PIXEL_SHARE_MIN = 0.99
SEGS_REL = 5e-3
# None: the group rule's G; then each G
GROUP_CASES = [None, 1, 2, 4, 8]

pytestmark = pytest.mark.cuda


def _force_group(monkeypatch, group):
    """Make render_sample_mean_mega launch rt_megakernel at ``group``."""
    if group is not None:
        monkeypatch.setattr(tmk, "_mega_cuda", functools.partial(
            tmk._mega_cuda, _group=group))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _since(before):
    """The program counts added since ``before`` (a ``trace.counts()``)."""
    return trace.counts() - before


def _rays(dev, width=128, height=64, **cam):
    cfg = rtt.CameraConfig(width=width, height=height, **cam)
    o, d = tcam.primary_rays(tcam.build_camera(cfg), width, height,
                             pixel_order=tcam.morton_order(width, height),
                             device=dev)
    return o.T.contiguous(), d.T.contiguous()


@pytest.mark.parametrize("group", GROUP_CASES)
def test_nearest_hit_kernel_matches_plain(dev, group):
    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    ps = tsweep.pack(scene)
    g = np.random.default_rng(5)
    n = 1 << 16
    o = np.stack([g.uniform(-6, 6, n), g.uniform(-1.5, 3.0, n),
                  g.uniform(-2, 11, n)]).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    before = trace.counts()
    got = tsweep.nearest_hit(ps, o, d, _group=group)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_nearest_hit": 1}
    want = tsweep.nearest_hit_reference(ps, o, d)
    same = got[1] == want[1]
    assert float((~same).float().mean()) <= 1e-4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a[same], b[same])
        assert torch.equal(a, b)


def _tie_scene(dev):
    """test_torch_tie_scene.py's scene with A duplicated into another
    cluster."""
    from raytracer_tpu_torch.models.materials import Material as TMaterial
    scene = tie_scene.build(SceneBuilder(), TMaterial.default(),
                            device="cpu")
    c, r, cl, ab = tie_scene.duplicate_a(
        scene.sph_center.numpy(), scene.sph_radius.numpy(),
        scene.sph_clusters.numpy(), int(scene.sph_leaf))
    scene = dataclasses.replace(scene, sph_center=torch.as_tensor(c),
                                sph_radius=torch.as_tensor(r),
                                sph_clusters=torch.as_tensor(cl))
    return scene.to(dev), ab


@pytest.mark.parametrize("group", GROUP_CASES)
def test_nearest_hit_kernel_exact_ties(dev, group):
    """On exact ties (a sphere and a triangle at one t; two identical
    spheres in two clusters, entered in either order) the kernel returns
    the plain version's winner at every G: the sphere, then the lower
    index."""
    scene, ab = _tie_scene(dev)
    ps = tsweep.pack(scene)
    o, d = (torch.as_tensor(x, device=dev) for x in tie_scene.rays())
    got = tsweep.nearest_hit(ps, o, d, _group=group)
    want = tsweep.nearest_hit_reference(ps, o, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n = tie_scene.N_AXIS
    assert bool((got[1][n:2 * n] == 2 * min(ab)).all())
    assert not bool((got[1] == 2 * max(ab)).any())
    assert bool(((got[1] & 1)[:n] == 0).all())


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
    before = trace.counts()
    got = tmk.fetch_image(ms, u, v, mid)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_fetch_image": 1}
    m = ms.mat[:, mid.long().clamp(0, ms.mat.shape[1] - 1)]
    want = torch.stack(tmk.fetch_image_reference(
        ms.tex, ms.img_rows, u, v, m[tmk._M_TW], m[tmk._M_TH],
        m[tmk._M_TROW]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", GROUP_CASES)
@pytest.mark.parametrize("num", [4, 2])
@pytest.mark.parametrize("pixpack", [1, 8])
def test_megakernel_matches_plain(dev, pixpack, num, group, monkeypatch):
    """Scene 4 and scene 2 (the image-textured earth: K4 inside K1), at
    every group size: bitwise with mega_reference."""
    _force_group(monkeypatch, group)
    scene, sky = rtt.build_scene(num, seed=0, device=dev) if num == 4 else \
        rtt.build_scene(num, device=dev)
    ms = tmk.MegaScene(scene)
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5).with_sky(sky)
    o, d = _rays(dev)
    key = trng.fold_in(trng.key(0), 1)
    before = trace.counts()
    mean, segs, depth = tmk.render_sample_mean_mega(
        ms, s, o, d, key, want_depth=True, pixpack=pixpack)
    torch.cuda.synchronize()
    assert _since(before) == collections.Counter(
        {"rt_megakernel": 1, "rt_megakernel.image": int(num == 2)})
    o_p, d_p, seed, kw = tmk.mega_inputs(ms, s, o, d, key, pixpack=pixpack)
    ref = tmk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    n = o.shape[1]
    err = (mean - ref[:3, :n]).abs().amax(dim=0)
    assert float((err <= PIXEL_ABS).float().mean()) >= PIXEL_SHARE_MIN
    ref_segs = float(ref[3, :n].double().sum())
    assert abs(float(segs) - ref_segs) <= SEGS_REL * ref_segs
    assert torch.equal(depth < tmk.INF, ref[4, :n] < tmk.INF)
    assert torch.equal(mean, ref[:3, :n]) and torch.equal(depth, ref[4, :n])
    assert float(segs) == ref_segs


@pytest.mark.parametrize("group", GROUP_CASES)
@pytest.mark.parametrize("rr", [0, 2])
@pytest.mark.parametrize("pixpack", [1, 8])
def test_coherent_megakernel_matches_plain(dev, pixpack, rr, group,
                                           monkeypatch):
    """rt_megakernel's coherent arm (one draw per tile and iteration)
    against mega_reference's on scene 4 at 256x128, russian roulette off
    and on, at every group size: bitwise, as the per-lane arm."""
    _force_group(monkeypatch, group)
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    ms = tmk.MegaScene(scene)
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5, coherent=True,
                           russian_roulette=rr).with_sky(sky)
    o, d = _rays(dev, 256, 128)
    key = trng.fold_in(trng.key(0), 2)
    before = trace.counts()
    mean, segs = tmk.render_sample_mean_mega(ms, s, o, d, key,
                                             pixpack=pixpack)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_megakernel": 1,
                              "rt_megakernel.coherent": 1}
    o_p, d_p, seed, kw = tmk.mega_inputs(ms, s, o, d, key, pixpack=pixpack)
    assert kw["coherent"]
    ref = tmk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    n = o.shape[1]
    err = (mean - ref[:3, :n]).abs().amax(dim=0)
    assert float((err <= PIXEL_ABS).float().mean()) >= PIXEL_SHARE_MIN
    ref_segs = float(ref[3, :n].double().sum())
    assert abs(float(segs) - ref_segs) <= SEGS_REL * ref_segs
    assert torch.equal(mean, ref[:3, :n]) and float(segs) == ref_segs
    per_lane, _ = tmk.render_sample_mean_mega(
        ms, rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                               russian_roulette=rr).with_sky(sky),
        o, d, key, pixpack=pixpack)
    assert not torch.equal(per_lane, mean)


def _tiles_vs_plain(ms, s, o, d, key, tiles, group):
    """rt_megakernel at ``group`` and mega_reference on the megakernel
    tiles t0 <= t < t1 of the frame (their rays, their tile offset):
    (kernel, plain) (5, pixels) outputs."""
    o_p, d_p, seed, kw = tmk.mega_inputs(ms, s, o, d, key)
    per = tmk.MEGA_TILE * kw["pixpack"]
    a, b = tiles[0] * per, tiles[1] * per
    o_p, d_p = o_p[:, a:b].contiguous(), d_p[:, a:b].contiguous()
    seed = (seed[0], seed[1], seed[2] + tiles[0])
    got = tmk._mega_cuda(ms.packed, ms.mat, o_p, d_p, seed, **kw,
                         _group=group)
    return got, tmk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)


def test_megakernel_stress10k_tiles(dev):
    """Two 1000x800 stress10k tiles (64 supers over 313 clusters) at G = 8
    and pixpack 8: bitwise with mega_reference."""
    from raytracer_tpu_torch.models import bench_scenes
    scene, sky = bench_scenes.stress_10k_scene(num=10000, seed=1,
                                               device=dev)
    ms = tmk.MegaScene(scene.to(dev))
    assert ms.packed.n_sph_sup > 0
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                           pixpack=8).with_sky(sky)
    o, d = _rays(dev, 1000, 800, position=(0.0, 1.0, -4.0))
    got, want = _tiles_vs_plain(ms, s, o, d, trng.fold_in(trng.key(0), 4),
                                (11, 13), 8)
    assert torch.equal(got, want)
    assert float((want[4] < tmk.INF).float().mean()) > 0.5


def test_cuda_renderer_checkpoint_is_bitwise(dev, tmp_path):
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
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


# -- the wavefront samplers' hit kernels: K5, K6 -----------------------------

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


def _bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("group", GROUP_CASES)
def test_hit_resolve_kernel_matches_plain(dev, group):
    """K5 (rt_hit_resolve) bitwise with its plain version on scene 4 and
    on a textured triangle scene, at every G."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    for scene in (rtt.build_scene(4, seed=0, device=dev)[0],
                  _field_scene(dev, n_sph=300)):
        ws = ic.WaveScene(scene, blocked=False)
        o, d = _field_rays(dev, 1 << 15)
        before = trace.counts()
        got = ic.hit_resolve_unit(ws, o, d, _group=group)
        torch.cuda.synchronize()
        assert _since(before) == {"rt_hit_resolve": 1}
        _bitwise(got, ic.hit_resolve_unit(ws, o, d, plain=True))


@pytest.mark.parametrize("group", GROUP_CASES)
def test_counting_hit_resolve_matches_plain(dev, group):
    """K5's with_stats arm at every G: its 12 outputs bitwise the plain
    K5's, and every ray's primitive-test count equal to the plain walk's
    (primitive_tests_reference), on scene 4 and on a field of spheres with
    supers and textured triangles."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    for scene in (rtt.build_scene(4, seed=0, device=dev)[0],
                  _field_scene(dev, n_sph=3000)):
        ps = tsweep.pack(scene)
        o, d = _field_rays(dev, 1 << 15)
        before = trace.counts()
        got = ic.hit_resolve_counted(ps, o, d, _group=group)
        torch.cuda.synchronize()
        assert _since(before) == {"rt_hit_resolve": 1,
                                  "rt_hit_resolve.stats": 1}
        _bitwise(got, ic.hit_resolve_counted(ps, o, d, plain=True))
        assert float(got[12].mean()) < scene.num_spheres + \
            scene.num_triangles


@pytest.mark.parametrize("group", GROUP_CASES)
def test_hit_resolve_kernel_exact_ties(dev, group):
    """K5 on the exact-tie scene at every G: the plain K5's winner, the
    sphere over the triangle and the lower index of two equal spheres."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene, ab = _tie_scene(dev)
    ws = ic.WaveScene(scene, blocked=False)
    o, d = (torch.as_tensor(x, device=dev) for x in tie_scene.rays())
    got = ic.hit_resolve_unit(ws, o, d, _group=group)
    _bitwise(got, ic.hit_resolve_unit(ws, o, d, plain=True))
    n = tie_scene.N_AXIS
    assert bool((got[1][n:2 * n] == 2 * min(ab)).all())
    assert bool(((got[1] & 1)[:n] == 0).all())


@pytest.mark.parametrize("group", GROUP_CASES)
def test_hit_resolve_blocked_kernel_matches_plain(dev, group):
    """K6 (rt_hit_resolve_blocked) bitwise with plain K6 on two sphere
    blocks, at every G, and against K5 on the same rays: only exact ties
    may differ."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene = _field_scene(dev)
    wb = ic.WaveScene(scene, blocked=True)
    assert wb.tables.nblocks == 2
    o, d = _field_rays(dev, 1 << 15)
    before = trace.counts()
    got = ic.hit_resolve_unit(wb, o, d, _group=group)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_hit_resolve_blocked": 1}
    _bitwise(got, ic.hit_resolve_unit(wb, o, d, plain=True))
    k5 = ic.hit_resolve_unit(ic.WaveScene(scene, blocked=False), o, d)
    differ = got[1] != k5[1]
    assert torch.equal(got[0][differ], k5[0][differ])


@pytest.mark.parametrize("group", GROUP_CASES)
def test_hit_resolve_blocked_kernel_exact_ties(dev, group):
    """K6 on the blocked variant of the exact-tie scene (two sphere
    blocks) at every G: the plain K6's winner in its visit order (block,
    spheres before triangles, index): P over T, the block-0 triangle T_Q
    over the block-1 sphere Q, A over its copy B."""
    from raytracer_tpu_torch.models.materials import Material as TMaterial
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene = tie_scene.blocked_variant(
        tie_scene.build_blocked(SceneBuilder(), TMaterial.default(),
                                device="cpu"),
        torch.as_tensor)
    wb = ic.WaveScene(scene.to(dev), blocked=True)
    o, d = (torch.as_tensor(x, device=dev) for x in tie_scene.blocked_rays())
    got = ic.hit_resolve_unit(wb, o, d, _group=group)
    _bitwise(got, ic.hit_resolve_unit(wb, o, d, plain=True))
    n = tie_scene.N_AXIS
    want = torch.as_tensor(tie_scene.blocked_axis_codes(scene), device=dev)
    assert torch.equal(got[1][:3 * n], want.to(torch.int32))
    assert not bool((got[1] == 2 * tie_scene.BLOCKED_SLOTS["b"]).any())


@pytest.mark.parametrize("sampler", ["regen", "scan", "rebin", "lanesort"])
def test_wavefront_frame_matches_plain_route(dev, sampler):
    """One small frame of each wavefront sampler through a Renderer on the
    card (the ray set-up and K5 launched, as many of one as of the other)
    against the plain route (every kernel replaced by its plain version) on the
    same rays and key."""
    from raytracer_tpu_torch.ops import integrator as tint
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                           sampler=sampler).with_sky(sky)
    cam = rtt.CameraConfig(width=64, height=32, position=(0.0, 0.5, -6.0))
    r = rtt.Renderer(scene, cam, s, device=dev)
    before = trace.counts()
    r.render_frame(block=True)
    c = _since(before)
    assert c["rt_hit_resolve"] == c["rt_wave_rays"] > 0
    assert r.accum.device.type == "cuda"
    ref, ref_segs = tint.render_sample_mean(
        r.packed_scene, s, r._o, r._d, trng.frame_key(r.base_key, 0),
        ray_idx=r._ray_idx, backend="plain")
    err = (r.accum - ref).abs().amax(dim=1)
    assert float((err <= PIXEL_ABS).float().mean()) >= PIXEL_SHARE_MIN
    assert abs(r.total_segments - float(ref_segs)) <= \
        SEGS_REL * float(ref_segs)


def test_coherent_regen_frame_matches_plain_route(dev):
    """A coherent regen Renderer frame on the card (K5 and the ray set-up
    once an iteration, the set-up drawing the tile bundles itself) against
    the plain route on the same rays and key."""
    from raytracer_tpu_torch.ops import integrator as tint
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                           sampler="regen", coherent=True).with_sky(sky)
    cam = rtt.CameraConfig(width=64, height=32, position=(0.0, 0.5, -6.0))
    r = rtt.Renderer(scene, cam, s, device=dev)
    before = trace.counts()
    r.render_frame(block=True)
    c = _since(before)
    assert c["rt_hit_resolve"] == c["rt_wave_rays"] > 0
    ref, ref_segs = tint.render_sample_mean(
        r.packed_scene, s, r._o, r._d, trng.frame_key(r.base_key, 0),
        ray_idx=r._ray_idx, backend="plain")
    err = (r.accum - ref).abs().amax(dim=1)
    assert float((err <= PIXEL_ABS).float().mean()) >= PIXEL_SHARE_MIN
    assert abs(r.total_segments - float(ref_segs)) <= \
        SEGS_REL * float(ref_segs)


# -- temporal mode: K7 and the temporal frame ---------------------------------

def test_warp_gather_kernel_matches_plain(dev):
    """rt_warp_gather (K7) bitwise: a coherent band, full-range random
    indices and indices past both ends (clamped before the load)."""
    from raytracer_tpu_torch.ops import warp
    g = np.random.default_rng(11)
    m = n = 1 << 18
    values = torch.as_tensor(g.integers(-2**31, 2**31 - 1, m,
                                        dtype=np.int64).astype(np.int32),
                             device=dev)
    band = np.arange(n) + g.integers(-300, 300, n)
    for idx in (band, g.integers(0, m, n), g.integers(-m, 2 * m, n)):
        idx = torch.as_tensor(idx.astype(np.int32), device=dev)
        valid = torch.as_tensor(g.uniform(size=n) < 0.8, device=dev)
        before = trace.counts()
        got = warp.warp_gather(values, idx, valid)
        torch.cuda.synchronize()
        assert _since(before) == {"rt_warp_gather": 1}
        assert torch.equal(got, warp.warp_gather_reference(values, idx,
                                                           valid))


def _history_inputs(dev, width, height):
    """A real move's projection: scene 4, old view (0, 0.5, -6), new view
    0.25 ahead and yawed 0.02; the depth is the kernel's primary hit. The
    old accumulation is random, past HIST_MAX on some channels, with
    weights 1-39 (so w > 0 exactly where the gather is valid) and cap 8."""
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=2).with_sky(sky)
    old = rtt.CameraConfig(width=width, height=height,
                           position=(0.0, 0.5, -6.0))
    new = rtt.CameraConfig(width=width, height=height,
                           position=(0.0, 0.5, -5.75), y_rot=0.02)
    o, d = tcam.primary_rays(tcam.build_camera(new), width, height,
                             device=dev)
    _, _, depth = tmk.render_sample_mean_mega(
        tmk.MegaScene(scene), s, o.T, d.T, trng.key(3), want_depth=True)
    g = np.random.default_rng(12)
    accum = torch.as_tensor(g.uniform(0, 10, (width * height, 3)).astype(
        np.float32), device=dev)
    wpix = torch.as_tensor(g.integers(1, 40, width * height).astype(
        np.float32), device=dev)
    ob = tcam.build_camera(old)
    return (o, d, depth, accum, wpix, 8.0, ob.position, ob.tl_pixel,
            ob.delta_u, ob.delta_v)


def test_temporal_renderer_matches_plain_steps(dev):
    """A 256x128 temporal Renderer frame, a move and a frame on the card
    (each frame rt_camera_rays, the megakernel and rt_temporal_frame; no
    K7) against the same steps composed from the plain
    versions on the same keys, bitwise."""
    from raytracer_tpu_torch.ops import warp
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5).with_sky(sky)
    cam = rtt.CameraConfig(width=256, height=128, position=(0.0, 0.5, -6.0))
    moved = rtt.CameraConfig(width=256, height=128,
                             position=(0.0, 0.5, -5.75), y_rot=0.02)
    r = rtt.Renderer(scene, cam, s, device=dev, temporal=True)
    before = trace.counts()
    r.render_frame(block=True)
    r.move_camera(moved)
    r.render_frame(block=True)
    assert _launched_since(before) == {"rt_megakernel": 2,
                                       "rt_camera_rays": 2,
                                       "rt_temporal_frame": 2,
                                       "rt_warp_gather": 0}

    accum = torch.zeros((256 * 128, 3), device=dev)
    wpix = torch.zeros(256 * 128, device=dev)
    src = None
    for k, c in enumerate((cam, moved)):
        cb = tcam.build_camera(c)
        rays = tcam.camera_rays_reference(cb, 256, 128, r.settings.pixpack,
                                          dev)
        o_p, d_p, seed, kw = tmk.mega_inputs(
            r._mega, r.settings, rays, None, trng.frame_key(r.base_key, k))
        out = tmk.mega_reference(r._mega.packed, r._mega.mat, o_p, d_p,
                                 seed, **kw)
        accum, wpix, segs = warp.temporal_frame_reference(
            out, 256 * 128, accum, wpix, src, cb, 256, 128)
        src = warp.history_source(accum, wpix, 8.0, cb)
    assert torch.equal(r.accum, accum) and torch.equal(r._wpix, wpix)
    assert float(r._last_segs) == float(segs)
    assert float((r._wpix > 1).float().mean()) > 0.3
    r.check_health()


def _launched_since(before) -> dict:
    """The temporal frame's launches since ``before`` (a
    ``trace.counts()``), K7 among them."""
    c = _since(before)
    return {k: c[k] for k in ("rt_megakernel", "rt_camera_rays",
                              "rt_temporal_frame", "rt_warp_gather")}


@pytest.mark.parametrize("width,height,pixpack",
                         [(3840, 2160, 8), (1000, 800, 1), (130, 70, 1),
                          (130, 70, 8), (64, 48, 8)])
def test_camera_rays_kernel_matches_plain(dev, width, height, pixpack):
    """rt_camera_rays bitwise with camera_rays_reference (pad_rays over
    primary_rays: torch's vector_norm and rsqrt on the card) on every
    padded lane, pad lanes o = 0 and d = (1, 0, 0)."""
    cam = tcam.build_camera(rtt.CameraConfig(
        width=width, height=height, position=(0.0, 0.5, -5.5), y_rot=0.04,
        x_rot=-0.02))
    before = trace.counts()
    got = tcam.camera_rays(cam, width, height, pixpack, dev)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_camera_rays": 1}
    want = tcam.camera_rays_reference(cam, width, height, pixpack, dev)
    assert torch.equal(got.o, want.o) and torch.equal(got.d, want.d)
    n = width * height
    assert (got.n, got.pixpack) == (n, pixpack)
    assert not got.o[:, n:].any() and not got.d[1:, n:].any()
    assert (got.d[0, n:] == 1).all()


@pytest.mark.parametrize("arm", ["static", "warp"])
def test_temporal_frame_kernel_matches_plain(dev, arm):
    """rt_temporal_frame bitwise with temporal_frame_reference on a real
    move (_history_inputs' depth and old view, 512x256) in a wider output
    with a random mean and segment counts: the static arm's blend in
    place, the warp arm's gather and blend into new planes, and the
    segment count equal in both, launch after launch."""
    from raytracer_tpu_torch.ops import warp
    width, height = 512, 256
    n = width * height
    o, d, depth, accum, wpix, cap, *old = _history_inputs(dev, width,
                                                          height)
    g = np.random.default_rng(13)
    out = torch.as_tensor(g.uniform(0, 2, (5, 32768 * 5)).astype(np.float32),
                          device=dev)
    out[3] = torch.as_tensor(g.integers(0, 300, out.shape[1]).astype(
        np.float32), device=dev)
    out[4, :n] = depth
    old_cam = tcam.CameraArrays(*old)
    new = tcam.build_camera(rtt.CameraConfig(
        width=width, height=height, position=(0.0, 0.5, -5.75), y_rot=0.02))
    extra = () if arm == "static" else (
        warp.history_source(accum, wpix, cap, old_cam), new, width, height)
    want = warp.temporal_frame_reference(out, n, accum.clone(),
                                         wpix.clone(), *extra)
    for _ in range(2):      # the segment accumulator is left zero
        a, w = accum.clone(), wpix.clone()
        before = trace.counts()
        got = warp.temporal_frame(out, n, a, w, *extra)
        torch.cuda.synchronize()
        assert _since(before) == {"rt_temporal_frame": 1}
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float(got[2]) == float(want[2]) > 0
    assert (got[0] is a) == (arm == "static")
    if arm == "warp":
        assert torch.equal(a, accum) and torch.equal(w, wpix)
        assert 0.2 < float((got[1] > 1).float().mean()) < 1.0


def test_warp_frame_launches_three_kernels(dev):
    """A 4K temporal Renderer's warp frames: each move and frame is one
    rt_camera_rays, one megakernel and one rt_temporal_frame launch, no
    K7; static frames reuse the rays."""
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5,
                           antialias=True).with_sky(sky)
    cams = [rtt.CameraConfig(width=3840, height=2160,
                             position=(0.0, 0.5, -6.0 + 0.25 * i),
                             y_rot=0.02 * i) for i in range(4)]
    r = rtt.Renderer(scene, cams[0], s, device=dev, temporal=True)
    r.render_frame(block=True)
    before = trace.counts()
    for cam in cams[1:]:
        r.move_camera(cam)
        r.render_frame()
    torch.cuda.synchronize()
    assert _launched_since(before) == {
        "rt_megakernel": 3, "rt_camera_rays": 3, "rt_temporal_frame": 3,
        "rt_warp_gather": 0}
    before = trace.counts()
    r.render_frame(block=True)
    assert _launched_since(before) == {
        "rt_megakernel": 1, "rt_camera_rays": 0, "rt_temporal_frame": 1,
        "rt_warp_gather": 0}
    hits = r._depth < tmk.INF
    assert float((r._wpix[hits] > 1).float().mean()) > 0.5
    r.check_health()


# -- multi-device rendering: pixel slices joined, a one-rank NCCL group ------

@pytest.mark.parametrize("pixpack", [1, 8])
def test_pixel_shards_join_to_the_unsharded_frame(dev, pixpack):
    """Two pixel ranks rendered in turn on the card through the local step
    (one whole tile each, tile ids offset by whole kernel tiles, ROADMAP
    F6), joined: bitwise the unsharded megakernel frame; rank 1 also
    bitwise mega_reference on its slice at its tile offset."""
    from raytracer_tpu_torch.ops.integrator import render_sample_mean
    from raytracer_tpu_torch.parallel import shard
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                           pixpack=pixpack).with_sky(sky)
    ms = tmk.MegaScene(scene.to(dev))
    w, h = 128, 2 * tmk.MEGA_TILE * pixpack // 128
    o, d = tcam.primary_rays(tcam.build_camera(rtt.CameraConfig(
        width=w, height=h, position=(0.0, 0.5, -6.0))), w, h, device=dev)
    idx = torch.arange(w * h, dtype=torch.int32, device=dev)
    key = trng.key(3)
    ref, ref_segs = render_sample_mean(ms, s, o, d, trng.frame_key(key, 0),
                                       ray_idx=idx)
    parts = []
    for r in range(2):
        rows = shard.shard_rows(w * h, r, 2)
        parts.append(shard.local_mean(ms, s, idx[rows], o[rows], d[rows], 0,
                                      key, px=(r, 2)))
    assert torch.equal(torch.cat([p[0] for p in parts]), ref)
    assert sum(float(p[1]) for p in parts) == float(ref_segs)
    n = w * h // 2
    offset = shard.local_tiles(ms, s, n)
    assert offset == 1
    o_p, d_p, seed, kw = tmk.mega_inputs(ms, s, o[n:].T, d[n:].T,
                                         trng.frame_key(key, 0), offset)
    plain = tmk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    assert torch.equal(parts[1][0], plain[:3, :n].T)


@pytest.fixture
def nccl_group(dev, monkeypatch):
    """A one-rank NCCL process group from torchrun's environment."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.distributed import initialize
    from raytracer_tpu_torch.parallel.dryrun import free_port
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(var, value)
    initialize()
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_renderer_matches_unsharded(dev, nccl_group,
                                                  tmp_path):
    """A one-rank NCCL Renderer(sharding=...): frames, segments, the
    health check's all-reduce and a checkpoint round trip (gather, rank 0
    writes, barrier) bitwise with the unsharded Renderer."""
    from raytracer_tpu_torch.parallel import mesh
    from raytracer_tpu_torch.parallel.distributed import gather_image
    assert nccl_group.get_backend() == "nccl"
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5).with_sky(sky)
    cam = rtt.CameraConfig(width=96, height=64, position=(0.0, 0.5, -6.0))
    placement = mesh.pixel_sharding(mesh.make_mesh())
    rs = rtt.Renderer(scene, cam, s, device=dev, sharding=placement)
    ru = rtt.Renderer(scene, cam, s, device=dev)
    before = trace.counts()
    rs.render_frames(2)
    assert _since(before)["rt_megakernel"] == 2
    ru.render_frames(2)
    assert torch.equal(torch.as_tensor(gather_image(rs.accum, placement)),
                       ru.accum.cpu())
    assert rs.stats_log[-1]["segments"] == ru.stats_log[-1]["segments"]
    assert rs.image().shape == (64, 96, 3)
    rs.check_health()
    path = str(tmp_path / "nccl.npz")
    rs.save_checkpoint(path)
    resumed = rtt.Renderer(scene, cam, s, device=dev, sharding=placement)
    resumed.load_checkpoint(path)
    for r in (resumed, ru):
        r.render_frame(block=True)
    assert torch.equal(resumed.accum, ru.accum)


def test_trace_kernel_route_matches_plain(dev):
    """``trace`` through the ray set-up and K5 (one launch of each a
    bounce) against its plain route on the same rays and key, bitwise."""
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5).with_sky(sky)
    w, h = 256, 128
    order = tcam.morton_order(w, h)
    o, d = rtt.primary_rays(rtt.build_camera(rtt.CameraConfig(
        width=w, height=h, position=(0.0, 0.5, -6.0))), w, h,
        pixel_order=order, device=dev)
    idx = torch.as_tensor(order, device=dev)
    before = trace.counts()
    rad, segs = rtt.trace(scene, s, o, d, trng.key(5), ray_idx=idx)
    c = _since(before)
    assert (c["rt_hit_resolve"], c["rt_wave_rays"]) == (5, 5)
    ref, ref_segs = rtt.trace(scene, s, o, d, trng.key(5), ray_idx=idx,
                              backend="plain")
    assert rad.device.type == "cuda" and torch.equal(rad, ref)
    assert float(segs) == float(ref_segs) > w * h


def test_profile_frame_trace_names_the_megakernel(dev, tmp_path):
    """``Renderer.profile_frame`` on the card writes a Chrome trace whose
    device events hold the kernel ``rt_megakernel`` launches."""
    import json
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5).with_sky(sky)
    r = rtt.Renderer(scene, rtt.CameraConfig(width=96, height=64), s,
                     device=dev)
    r.render_frame(block=True)
    before = trace.counts()
    path = r.profile_frame(str(tmp_path / "trace"))
    assert _since(before)["rt_megakernel"] == 1 and r.frame_num == 2
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "megakernel" in e.get("name", "")
               for e in events)


def test_builders_default_to_the_card(dev):
    """With no device the builders build on the card."""
    from raytracer_tpu_torch.models import bench_scenes
    from raytracer_tpu_torch.utils import vec
    scene, _ = rtt.build_scene(4, seed=0)
    b = SceneBuilder()
    b.add_sphere((0, 0, 3), 0.5, Material.default())
    o, d = rtt.primary_rays(rtt.build_camera(rtt.CameraConfig(
        width=8, height=4)), 8, 4)
    for t in (scene.sph_center, b.build().sph_center, o, d,
              rtt.film.new_accumulator(32),
              bench_scenes.rtiow_trio_scene()[0].sph_center,
              vec.vec3(0, 0, 1)):
        assert t.device.type == "cuda"


# -- the fused bounce (rt_wave_bounce) and the replayed wavefront loop -------

def _bounce_scene(dev, num):
    """Scenes 1-4, scene 2 with a 256x512 procedural earth ("earth") and
    a gradient-textured sphere under an emissive one ("gradient")."""
    if num == "gradient":
        b = SceneBuilder()
        b.add_sphere((0.0, 0.0, 1.7), 0.3,
                     Material.standard(Texture.gradient(), 0.2))
        b.add_sphere((0.3, 0.35, 1.5), 0.1,
                     Material.emissive((1.0, 0.9, 0.8), 4))
        return b.build(device=dev), True
    if num == "earth":
        return rtt.build_scene(2, device=dev,
                               earth_image=procedural_earth_texture(256))
    return rtt.build_scene(num, device=dev,
                           **({"seed": 0} if num == 4 else {}))


BOUNCE_VARIANTS = {"base": {}, "rr": {"russian_roulette": 1},
                   "fix_emissive": {"fix_exit_ior": True,
                                    "emissive_terminates": True}}


def _bounce_vs_plain(dev, scene, s, pos, regen, blocked=None, bounces=4):
    """``bounces`` bounces of 128x64 lanes: rt_wave_bounce bitwise with
    wave_bounce_reference on the same raw hit outputs, ray set-up and
    state, the state advancing with the kernel's."""
    from raytracer_tpu_torch.ops import bounce as tb
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene, hit_raw
    from raytracer_tpu_torch.ops.rays import wave_rays
    ws = WaveScene(scene, blocked=blocked)
    o, d = _rays(dev, 128, 64, position=pos)
    n = o.shape[1]
    keys = trng.per_ray_keys(trng.key(7), torch.arange(n, device=dev))
    use_rr = s.russian_roulette > 0
    st = {"o": o, "d": d, "thru": torch.ones_like(o),
          "rad": torch.zeros_like(o),
          "cur_ior": torch.ones(n, dtype=torch.float32, device=dev)}
    if regen:
        st.update(pixel_sum=torch.zeros_like(o), o0p=o, d0p=d,
                  sample_i=torch.zeros(n, dtype=torch.int32, device=dev),
                  bounce_i=torch.zeros(n, dtype=torch.int32, device=dev))
    else:
        st["alive"] = torch.ones(n, dtype=torch.bool, device=dev)
    for b in range(bounces):
        if regen:
            rays = wave_rays(st["d"], keys=keys, sample_i=st["sample_i"],
                             bounce=st["bounce_i"], with_rr=use_rr,
                             spp=s.rays_per_pixel)
        else:
            rays = wave_rays(st["d"], keys=keys, bounce=b, with_rr=use_rr)
        raw = hit_raw(ws, st["o"], rays.unit)
        assert len(raw) == (9 if ws.blocked else 12)
        args = (scene, s, st, rays.dj, raw, rays.inv_len, rays.gauss,
                rays.fresnel, rays.rr)
        before = trace.counts()
        got = tb.wave_bounce(*args, regen=regen, bounce=b)
        torch.cuda.synchronize()
        assert _since(before) == {"rt_wave_bounce": 1}
        want = tb.wave_bounce_reference(*args, regen=regen, bounce=b)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        st.update(got)


@pytest.mark.parametrize("variant", sorted(BOUNCE_VARIANTS))
@pytest.mark.parametrize("arm", ["scan", "regen"])
@pytest.mark.parametrize("num", [1, 2, 3, 4, "earth", "gradient"])
def test_wave_bounce_kernel_matches_plain(dev, num, arm, variant):
    """rt_wave_bounce bitwise with wave_bounce_reference on the card, four
    bounces of 128x64 lanes fed the same raw K5 outputs and randoms, in
    both arms (regen with parking); the resolve (sphere UV on the earth
    and scene 2) inside the kernel."""
    scene, sky = _bounce_scene(dev, num)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                           **BOUNCE_VARIANTS[variant]).with_sky(sky)
    pos = (0.0, 0.5, -6.0) if num == 4 else (0.0, 0.0, 0.0)
    _bounce_vs_plain(dev, scene, s, pos, arm == "regen")


@pytest.mark.parametrize("arm", ["scan", "regen"])
@pytest.mark.parametrize("num", [1, 2, 3, "earth", "gradient"])
def test_wave_bounce_kernel_on_k6_raw(dev, num, arm):
    """rt_wave_bounce on K6's 9 raw outputs (colour30 and smooth|mat
    decoded in the kernel), the scene forced onto the blocked layout,
    bitwise with wave_bounce_reference."""
    scene, sky = _bounce_scene(dev, num)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                           russian_roulette=1).with_sky(sky)
    _bounce_vs_plain(dev, scene, s, (0.0, 0.0, 0.0), arm == "regen",
                     blocked=True)


def _rays_equal(got, want, done=None):
    """rt_wave_rays' outputs bitwise the plain version's: every output of
    a live lane; a finished lane's (``done``) unit direction and 1 / |d|,
    ``PARK_UNIT`` and 1 (its dj and draws are unspecified)."""
    from raytracer_tpu_torch.ops.rays import PARK_UNIT
    live = slice(None) if done is None else ~done
    for k in ("dj", "unit", "inv_len", "gauss", "fresnel", "rr"):
        a, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert a is None, k
        else:
            assert a.shape == w.shape, k
            assert torch.equal(a[..., live], w[..., live]), k
    if done is not None:
        m = int(done.sum())
        assert torch.equal(got.unit[:, done], torch.tensor(
            PARK_UNIT, device=done.device)[:, None].expand(3, m))
        assert torch.equal(got.inv_len[done],
                           torch.ones(m, device=done.device))


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("with_rr", [False, True])
@pytest.mark.parametrize("antialias", [True, False])
def test_wave_rays_kernel_matches_plain(dev, antialias, with_rr, coherent):
    """rt_wave_rays bitwise with wave_rays_reference on 200,000 lanes
    (not a whole number of 4096-ray tiles): the regen arm (sample fold,
    per-lane bounces, count of sample_i < spp), the scan arm (one bounce,
    the alive mask counted) and the coherent arm (the 1024-lane tile's
    bundle drawn in the kernel under a host tile key, counting by the
    sample or by the alive mask); one launch each, every output and the
    segment count equal (a finished lane, sample_i >= spp: the park
    walk's direction)."""
    from raytracer_tpu_torch.ops import rays as trays
    n = 200_000
    g = np.random.default_rng(12)
    keys = trng.per_ray_keys(trng.key(5), torch.arange(n, device=dev))
    s = torch.as_tensor(g.integers(0, 30, n).astype(np.int32), device=dev)
    b = torch.as_tensor(g.integers(0, 6, n).astype(np.int32), device=dev)
    d = torch.as_tensor(g.standard_normal((3, n)).astype(np.float32) * 2,
                        device=dev)
    alive = s < 12
    if coherent:
        tile_key = trng.fold_in(trng.key(3), 4)
        arms = [dict(tile_key=tile_key, sample_i=s, spp=20),
                dict(tile_key=trng.fold_in(tile_key, 9), alive=alive)]
    else:
        arms = [dict(keys=keys, sample_i=s, bounce=b, spp=20),
                dict(keys=keys, bounce=3, alive=alive)]
    for kw in arms:
        segs = [torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(2)]
        before = trace.counts()
        got = trays.wave_rays(d, antialias=antialias, with_rr=with_rr,
                              segs=segs[0], **kw)
        torch.cuda.synchronize()
        assert _since(before) == {"rt_wave_rays": 1}
        want = trays.wave_rays(d, antialias=antialias, with_rr=with_rr,
                               segs=segs[1], plain=True, **kw)
        assert _since(before) == {"rt_wave_rays": 1}
        done = s >= 20 if "spp" in kw else None
        _rays_equal(got, want, done)
        assert int(segs[0]) == int(segs[1]) > 0


@pytest.mark.parametrize("n", [200_003, 204_800])
def test_coherent_wave_rays_graph_replay(dev, n):
    """The coherent arm keyed from device memory under a captured CUDA
    graph, replayed twice: each replay draws under fold_in(key, it) with
    the counter it finds, bitwise the plain version keyed by the host,
    and advances the counter by exactly one (the ticket left zero); over
    a partial last tile and over 200 whole ones."""
    from raytracer_tpu_torch.ops import rays as trays
    g = np.random.default_rng(13)
    s = torch.as_tensor(g.integers(0, 30, n).astype(np.int32), device=dev)
    d = torch.as_tensor(g.standard_normal((3, n)).astype(np.float32),
                        device=dev)
    k = trng.fold_in(trng.key(7), 1)
    key_dev = torch.zeros(2, dtype=torch.int64, device=dev)
    trng.set_key(key_dev, k)
    iter_dev = torch.tensor([4, 0], dtype=torch.int64, device=dev)
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    kw = dict(sample_i=s, spp=20, with_rr=True, segs=segs)
    trays.wave_rays(d, key_dev=key_dev, iter_dev=iter_dev, **kw)  # warm-up
    torch.cuda.synchronize()
    assert iter_dev.tolist() == [5, 0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = trays.wave_rays(d, key_dev=key_dev, iter_dev=iter_dev, **kw)
    for it in (5, 6):
        segs.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert iter_dev.tolist() == [it + 1, 0]
        want = trays.wave_rays(d, tile_key=trng.fold_in(k, it), plain=True,
                               **dict(kw, segs=None))
        _rays_equal(got, want, s >= 20)
        assert int(segs) == int((s < 20).sum())


GRAPH_CASES = [("regen", False), ("regen", True), ("scan", False),
               ("rebin", False), ("lanesort", False)]


@pytest.mark.parametrize("sampler,coherent", GRAPH_CASES)
def test_graph_replay_matches_plain_route(dev, sampler, coherent):
    """Two Renderer frames replay the captured iterations (12 a regen
    frame: a block of 8 and one of 4), each running mean bitwise the
    plain route's (every kernel replaced by its plain version, eager)."""
    from raytracer_tpu_torch.ops import integrator as tint
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=2).with_sky(sky)
    cam = rtt.CameraConfig(width=64, height=32, position=(0.0, 0.5, -6.0))
    r = rtt.Renderer(scene, cam, s, device=dev)
    accum = rtt.film.new_accumulator(64 * 32, dev)
    before = trace.counts()
    for frame in range(2):
        r.render_frame(block=True)
        tint.render_frame(r.packed_scene, s, r._o, r._d, accum, frame,
                          r.base_key, ray_idx=r._ray_idx, backend="plain")
        assert torch.equal(r.accum, accum)
    assert _since(before)["graph.replay"] > 0 and r.packed_scene.graphs


def test_camera_change_replays_without_recapture(dev):
    """A new camera writes its rays into the captured graph's static
    inputs: no capture after the first frame (8 iterations a frame, one
    graph), every frame bitwise the plain route's, and ``trace`` on the
    same WaveScene captures its own graph once."""
    from raytracer_tpu_torch.ops import integrator as tint
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=4,
                           sampler="regen").with_sky(sky)
    r = rtt.Renderer(scene, rtt.CameraConfig(
        width=64, height=32, position=(0.0, 0.5, -6.0)), s, device=dev)
    r.render_frame(block=True)
    before = trace.counts()
    for pos in ((0.2, 0.6, -5.5), (-0.4, 0.4, -6.5)):
        r.set_camera(rtt.CameraConfig(width=64, height=32, position=pos))
        r.render_frame(block=True)
        want, _ = tint.render_sample_mean(
            r.packed_scene, s, r._o, r._d, trng.frame_key(r.base_key, 0),
            ray_idx=r._ray_idx, backend="plain")
        assert torch.equal(r.accum, want)
    assert _since(before)["graph.capture"] == 0
    for key in (3, 4):
        rad, _ = rtt.trace(r.packed_scene, s, r._o, r._d, trng.key(key),
                           ray_idx=r._ray_idx)
        want, _ = rtt.trace(r.packed_scene, s, r._o, r._d, trng.key(key),
                            ray_idx=r._ray_idx, backend="plain")
        assert torch.equal(rad, want)
    assert _since(before)["graph.capture"] == 1


def test_graph_launch_counts_add_up(dev):
    """The counts stay truthful under replay: a regen frame of 8
    iterations (one replay) counts 8 launches of K5, the ray set-up and
    rt_wave_bounce; a trace of 5 bounces 5 of each in one replay."""
    from raytracer_tpu_torch.ops import integrator as tint
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    ws = ic.WaveScene(scene)
    o, d = _rays(dev, 64, 32, position=(0.0, 0.5, -6.0))
    o, d = o.T.contiguous(), d.T.contiguous()
    for s, want in ((rtt.RenderSettings(rays_per_pixel=2, reflect_limit=4,
                                        sampler="regen").with_sky(sky), 8),
                    (rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5,
                                        sampler="scan").with_sky(sky), 5)):
        for _ in range(2):      # the first call captures, both replay
            before = trace.counts()
            tint.render_sample_mean(ws, s, o, d, trng.key(1))
            torch.cuda.synchronize()
            c = _since(before)
            assert [c[k] for k in ("rt_hit_resolve", "rt_wave_rays",
                                   "rt_wave_bounce", "graph.replay")] == \
                [want] * 3 + [1]


@pytest.mark.parametrize("num", [4, "stress"])
def test_regen_frame_launches_three_kernels_an_iteration(dev, num):
    """A regen Renderer frame at 128x64, 2 spp, 4 bounces (8 iterations,
    one replay after the capture): the ray set-up, the hit kernel (K5 on
    scene 4, K6 on a scene past the resident budget) and rt_wave_bounce
    once an iteration each."""
    from raytracer_tpu_torch.models import bench_scenes
    if num == "stress":
        scene, sky = bench_scenes.stress_10k_scene(num=100000, seed=1)
        scene = scene.to(dev)
        pos = (0.0, 1.0, -4.0)
    else:
        scene, sky = rtt.build_scene(4, seed=0, device=dev)
        pos = (0.0, 0.5, -6.0)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=4,
                           sampler="regen").with_sky(sky)
    r = rtt.Renderer(scene, rtt.CameraConfig(width=128, height=64,
                                             position=pos), s, device=dev)
    r.render_frame(block=True)       # captures
    hit = ("rt_hit_resolve_blocked" if r.packed_scene.blocked
           else "rt_hit_resolve")
    before = trace.counts()
    r.render_frame(block=True)
    c = _since(before)
    assert [c[k] for k in (hit, "rt_wave_rays", "rt_wave_bounce")] == \
        [8, 8, 8]
    assert r.packed_scene.blocked == (num == "stress")


# -- finished regen lanes: skipped by the ray set-up and the bounce ----------

FINISHED_CASES = ["none", "half", "all", "one_block"]


def _finished_lanes(dev, case):
    """Scene 4's 128x64 regen lanes (32 blocks of 256) after two plain
    iterations at 4 spp, 5 bounces, russian roulette from bounce 2; then
    the lanes of ``case`` finished (sample_i = spp) and parked, as the
    loop leaves them: none, every other lane (each block holds both
    kinds), all, or the first half of block 5 alone."""
    from raytracer_tpu_torch.ops import bounce as tb
    from raytracer_tpu_torch.ops import integrator as tint
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                           sampler="regen", russian_roulette=2).with_sky(sky)
    o, d = _rays(dev, 128, 64, position=(0.0, 0.5, -6.0))
    n = o.shape[1]
    keys = trng.per_ray_keys(trng.key(9), torch.arange(n, device=dev))
    ws = WaveScene(scene)
    route = tint._Route(ws, s, "plain")
    st = tint._regen_state(o, d, keys)
    for it in range(2):
        tint._regen_iteration(route, st, it, False, False)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    if case == "half":
        done[1::2] = True
    elif case == "all":
        done[:] = True
    elif case == "one_block":
        done[5 * 256:5 * 256 + 128] = True
    st["sample_i"] = torch.where(done, s.rays_per_pixel, st["sample_i"])
    st["o"] = torch.where(done[None, :], tb.PARK_ORIGIN, st["o"])
    st["d"] = torch.where(done[None, :], torch.tensor(
        [[1.0], [0.0], [0.0]], device=dev), st["d"])
    return ws, s, keys, st, done


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("case", FINISHED_CASES)
def test_finished_lanes_match_plain(dev, case, coherent):
    """rt_wave_rays (per-lane or coherent arm) and rt_wave_bounce (regen
    arm, which parks) bitwise their plain versions with none, half
    (interleaved), all or half of one block of the lanes finished: the
    ray set-up gives a finished lane the unit direction ``PARK_UNIT``
    and 1 / |d| = 1 and counts only live lanes; the bounce leaves a
    finished lane's state as it was; two iterations, K5 between."""
    from raytracer_tpu_torch.ops import bounce as tb
    from raytracer_tpu_torch.ops.intersect_cuda import hit_raw
    from raytracer_tpu_torch.ops.rays import wave_rays
    ws, s, keys, st, done = _finished_lanes(dev, case)
    spp = s.rays_per_pixel
    for it in range(2):
        done = st["sample_i"] >= spp
        if coherent:
            kw = dict(tile_key=trng.fold_in(trng.key(4), it))
        else:
            kw = dict(keys=keys, bounce=st["bounce_i"])
        segs = [torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(2)]
        got = wave_rays(st["d"], sample_i=st["sample_i"], spp=spp,
                        with_rr=True, segs=segs[0], **kw)
        want = wave_rays(st["d"], sample_i=st["sample_i"], spp=spp,
                         with_rr=True, segs=segs[1], plain=True, **kw)
        torch.cuda.synchronize()
        _rays_equal(got, want, done)
        assert int(segs[0]) == int(segs[1]) == int((~done).sum())
        raw = hit_raw(ws, st["o"], got.unit)
        args = (ws.scene, s, st, got.dj, raw, got.inv_len, got.gauss,
                got.fresnel, got.rr)
        new = tb.wave_bounce(*args, regen=True)
        ref = tb.wave_bounce_reference(*args, regen=True)
        for k in ref:
            assert torch.equal(new[k], ref[k]), k
            assert torch.equal(new[k][..., done], st[k][..., done]), k
        st.update(new)


GRAPH_FINISHED_CASES = [("regen", False), ("regen", True), ("rebin", False),
                        ("lanesort", False)]


@pytest.mark.parametrize("sampler,coherent", GRAPH_FINISHED_CASES)
def test_graph_frame_lanes_match_plain_route(dev, monkeypatch, sampler,
                                             coherent):
    """A graph-replayed frame (scene 4, 64x32, 3 spp, 4 bounces: a block
    of 8 iterations and one of 4) against the eager plain route: the
    film bitwise, the segments equal, every lane's final ``sample_i``
    equal and every finished lane parked in both, and
    ``regen.lane_iterations`` grown by N x 12 on each."""
    from raytracer_tpu_torch.ops import bounce as tb
    from raytracer_tpu_torch.ops import integrator as tint
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=2).with_sky(sky)
    o, d = _rays(dev, 64, 32, position=(0.0, 0.5, -6.0))
    o, d = o.T.contiguous(), d.T.contiguous()
    n = o.shape[0]
    idx = torch.as_tensor(tcam.morton_order(64, 32), device=dev)
    fkey = trng.frame_key(trng.key(1), 0)
    ws = WaveScene(scene)
    states = []
    regen_state = tint._regen_state
    monkeypatch.setattr(tint, "_regen_state",
                        lambda *a: states.append(regen_state(*a))
                        or states[-1])
    out = {}
    for route in ("graph", "plain"):
        before = trace.counts()
        mean, segs = tint.render_sample_mean(
            ws, s, o, d, fkey, ray_idx=idx,
            backend="pallas" if route == "graph" else "plain")
        torch.cuda.synchronize()
        assert _since(before)["regen.lane_iterations"] == n * 12
        st = (ws.graphs[("regen", n, s, "pallas")].st if route == "graph"
              else states[-1])
        out[route] = (mean.clone(), float(segs), st["sample_i"].clone(),
                      st["o"].clone(), st["d"].clone())
    (gm, gs, gi, go, gd), (pm, ps, pi, po, pd) = out["graph"], out["plain"]
    assert torch.equal(gm, pm) and gs == ps
    assert torch.equal(gi, pi)
    done = gi >= s.rays_per_pixel
    assert bool(done.any())
    for x in (go, po):
        assert bool((x[:, done] == tb.PARK_ORIGIN).all())
    for x in (gd, pd):
        assert torch.equal(x[:, done], torch.tensor(
            [[1.0], [0.0], [0.0]], device=dev).expand(3, int(done.sum())))


# -- the SPD tetrahedral pyramid at level 6: a mesh past the resident budget --

@functools.lru_cache(maxsize=1)
def _tetra6(dev):
    """Level 6 (16,384 triangles): 512 leaves of 32 under 64 supers."""
    from raytracer_tpu_torch.models import bench_scenes
    scene, sky = bench_scenes.spd_tetra_scene(level=6, device=dev)
    assert tuple(scene.tri_supers.shape) == (64, 8)
    return scene, sky


def _tetra_rays(dev, n, seed=6):
    """``n`` rays from the camera's origin and from points in the
    pyramid's box, toward random points of the box: most of them enter
    it, and those from inside start among its faces."""
    g = np.random.default_rng(seed)
    lo, hi = np.array([-0.82, -0.14, 1.55]), np.array([0.82, 1.2, 2.98])
    o = np.where(g.uniform(size=(n, 1)) < 0.5, 0.0,
                 g.uniform(lo, hi, (n, 3)))
    d = g.uniform(lo, hi, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.T.astype(np.float32), device=dev).contiguous(),
            torch.as_tensor(d.T.astype(np.float32), device=dev).contiguous())


@pytest.mark.parametrize("group", GROUP_CASES)
def test_megakernel_tetra6_matches_plain(dev, group, monkeypatch):
    """K1 gates at depth 2 over the pyramid's triangle pool: a 64x48
    slice of the 1000x800 frame (the middle of the Morton order), 4 spp,
    bitwise mega_reference at every G."""
    _force_group(monkeypatch, group)
    scene, sky = _tetra6(dev)
    ms = tmk.MegaScene(scene)
    assert tsweep.gate_depth(ms.packed) == 2
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5).with_sky(sky)
    o, d = _rays(dev, 1000, 800, position=(0.0, 0.0, 0.0))
    mid = 400_000
    o = o[:, mid:mid + 64 * 48].contiguous()
    d = d[:, mid:mid + 64 * 48].contiguous()
    key = trng.fold_in(trng.key(0), 1)
    before = trace.counts()
    mean, segs, depth = tmk.render_sample_mean_mega(ms, s, o, d, key,
                                                    want_depth=True)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_megakernel": 1}
    o_p, d_p, seed, kw = tmk.mega_inputs(ms, s, o, d, key)
    ref = tmk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    n = o.shape[1]
    assert bool((depth < tmk.INF).float().mean() > 0.2)
    assert torch.equal(mean, ref[:3, :n]) and torch.equal(depth, ref[4, :n])
    assert float(segs) == float(ref[3, :n].double().sum())


@functools.lru_cache(maxsize=1)
def _tetra6_k6_plain(dev):
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    ws = ic.WaveScene(_tetra6(dev)[0])
    o, d = _tetra_rays(dev, 1 << 16)
    return ws, o, d, ic.hit_resolve_unit(ws, o, d, plain=True)


@pytest.mark.parametrize("group", GROUP_CASES)
def test_hit_resolve_blocked_tetra6_matches_plain(dev, group):
    """K6 on a triangle-only scene past the resident budget (16 blocks of
    1,024 triangles): 65,536 rays into the pyramid, bitwise plain K6 at
    every G."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    ws, o, d, want = _tetra6_k6_plain(dev)
    assert ws.blocked and ws.tables.nblocks == 16
    before = trace.counts()
    got = ic.hit_resolve_unit(ws, o, d, _group=group)
    torch.cuda.synchronize()
    assert _since(before) == {"rt_hit_resolve_blocked": 1}
    assert float((got[0] < tsweep.INF).float().mean()) > 0.2
    _bitwise(got, want)


def test_regen_tetra6_graph_replay_matches_eager(dev, monkeypatch):
    """Two regen Renderer frames on the pyramid replay the captured
    iterations with K6; each running mean is bitwise the eager kernel
    route's (every launch as a plain call, no graph)."""
    from raytracer_tpu_torch.ops import integrator as tint
    scene, sky = _tetra6(dev)
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                           sampler="regen").with_sky(sky)
    r = rtt.Renderer(scene, rtt.CameraConfig(width=64, height=48), s,
                     device=dev)
    assert r.packed_scene.blocked
    accum = rtt.film.new_accumulator(64 * 48, dev)
    before = trace.counts()
    for frame in range(2):
        r.render_frame(block=True)
        with monkeypatch.context() as m:
            m.setattr(tint, "_replays", lambda backend, o: False)
            tint.render_frame(r.packed_scene, s, r._o, r._d, accum, frame,
                              r.base_key, ray_idx=r._ray_idx)
        torch.cuda.synchronize()
        assert torch.equal(r.accum, accum)
    c = _since(before)
    assert c["graph.replay"] > 0 and c["rt_hit_resolve_blocked"] > 0


# -- the hit kernels skip finished regen lanes --------------------------------

SKIP_SCENES = ["scene4", "scene2", "tetra4"]


def _skip_scene(dev, name):
    """(scene, sky, camera position, blocked) of a skip test: K5 on scenes
    4 and 2, K6 on the level-4 SPD pyramid (1,024 triangles) forced onto
    the blocked layout."""
    from raytracer_tpu_torch.models import bench_scenes
    if name == "tetra4":
        return (*bench_scenes.spd_tetra_scene(level=4, device=dev),
                (0.0, 0.0, 0.0), True)
    if name == "scene4":
        return (*rtt.build_scene(4, seed=0, device=dev), (0.0, 0.5, -6.0),
                False)
    return (*rtt.build_scene(2, device=dev), (0.0, 0.0, 0.0), False)


def _skip_mask(n: int, spp: int, seed: int = 11):
    """The regen loop's ``sample_i`` over ``n`` lanes (n a multiple of 64)
    and its finished lanes: in the first half about a third finished at
    random, in the second whole aligned runs of 32 lanes finished (each
    run at random), so every G meets both mixed and finished warps."""
    g = torch.Generator().manual_seed(seed)
    done = torch.rand(n, generator=g) < 0.35
    half = n // 2
    done[half:] = (torch.rand(half // 32, generator=g) < 0.5
                   ).repeat_interleave(32)
    sample = torch.randint(0, spp, (n,), generator=g, dtype=torch.int32)
    return torch.where(done, spp, sample).to(torch.int32), done


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("name", SKIP_SCENES)
def test_hit_kernels_skip_finished_lanes(dev, monkeypatch, name, group):
    """K5 (scenes 4 and 2, 256x128 camera rays) and K6 (the level-4
    pyramid, 32,768 rays into it) launched with the regen loop's mask at
    every G: a live lane's rows bitwise the unmasked launch's, a finished
    lane's rows still the sentinel its output buffers were filled with
    (the kernel wrote nothing there), the launch counted under the
    kernel's ``.skip``; the plain route with the mask computes every row,
    the unmasked launch's."""
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene, _, pos, blocked = _skip_scene(dev, name)
    ws = ic.WaveScene(scene, blocked=blocked)
    if blocked:
        o, d = _tetra_rays(dev, 1 << 15)
    else:
        o, d = _rays(dev, 256, 128, position=pos)
        d = ic.unit_rays(d)[0]
    spp = 4
    sample, done = (x.to(dev) for x in _skip_mask(o.shape[1], spp))
    want = ic.hit_raw(ws, o, d, _group=group)
    assert bool((want[0][~done] < tsweep.INF).any())
    monkeypatch.setattr(ic, "_outs", lambda n, device, dtypes: [
        torch.full((n,), -7, dtype=dt, device=device) for dt in dtypes])
    kernel = "rt_hit_resolve_blocked" if blocked else "rt_hit_resolve"
    before = trace.counts()
    got = ic.hit_raw(ws, o, d, sample_i=sample, spp=spp, _group=group)
    torch.cuda.synchronize()
    assert _since(before) == {kernel: 1, kernel + ".skip": 1}
    assert len(got) == len(want) == (9 if blocked else 12)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert torch.equal(a[~done], w[~done])
        assert bool((a[done] == -7).all())
    _bitwise(ic.hit_raw(ws, o, d, plain=True, sample_i=sample, spp=spp),
             want)


SKIP_FRAME_CASES = [("regen", False), ("regen", True), ("rebin", False),
                    ("lanesort", False)]


@pytest.mark.parametrize("name", ["scene4", "tetra4"])
@pytest.mark.parametrize("sampler,coherent", SKIP_FRAME_CASES)
def test_masked_graph_frame_matches_plain_route(dev, monkeypatch, sampler,
                                                coherent, name):
    """A graph-replayed frame whose hit launches carry the regen loop's
    mask (64x32, 3 spp, 4 bounces; K5 on scene 4, K6 on the blocked
    level-4 pyramid; every hit launch of the replays counted under the
    kernel's ``.skip``) gives the plain route's film (the pixel sums over
    spp) and segments bitwise, and so does a fresh capture whose hit
    launches carry no mask."""
    from raytracer_tpu_torch.ops import integrator as tint
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene, sky, pos, blocked = _skip_scene(dev, name)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=2).with_sky(sky)
    o, d = _rays(dev, 64, 32, position=pos)
    o, d = o.T.contiguous(), d.T.contiguous()
    idx = torch.as_tensor(tcam.morton_order(64, 32), device=dev)
    fkey = trng.frame_key(trng.key(1), 0)
    kernel = "rt_hit_resolve_blocked" if blocked else "rt_hit_resolve"

    def frame(backend):
        before = trace.counts()
        mean, segs = tint.render_sample_mean(
            ic.WaveScene(scene, blocked=blocked), s, o, d, fkey,
            ray_idx=idx, backend=backend)
        torch.cuda.synchronize()
        c = _since(before)
        grown = (c[kernel], c[kernel + ".skip"],
                 c["regen.lane_iterations"] // o.shape[0])
        return mean.clone(), float(segs), grown
    masked = frame("pallas")
    assert masked[2][0] == masked[2][1] == masked[2][2] > 0
    plain = frame("plain")
    hit_raw = tint.hit_raw
    monkeypatch.setattr(tint, "hit_raw",
                        lambda ws, o_, d_, plain=False, **kw:
                        hit_raw(ws, o_, d_, plain))
    unmasked = frame("pallas")
    assert unmasked[2][1] == 0 and unmasked[2][0] == masked[2][0]
    for other in (plain, unmasked):
        assert torch.equal(masked[0], other[0])
        assert masked[1] == other[1] > 0
