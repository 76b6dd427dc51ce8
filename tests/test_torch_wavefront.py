"""raytracer_tpu_torch's wavefront samplers (ops/integrator.py, ops/rebin.py)
against raytracer_tpu, and the JAX package's sampler contracts on the port.

Against JAX: the port and JAX draw the same uniforms and their normals within
a few ulps (test_torch_wavefront_ops.py), so a pixel differs only where float
rounding sends a path another way. On scene 1 that never happens (every
pixel equal at 24x16). Scene 4 has glass spheres and hits at silhouettes,
where torch's and XLA's roundings (rsqrt, FMA contraction, the order of the
oracle's dot products; ROADMAP F2) move paths, so it is held to per-pixel
quantiles: measured 93.3-93.8% of 64x32 pixels within 1e-4 and mean |d|
2.8e-3-3.7e-3 over frames 3 and 4. Segments agree within 0.15% on the oracle
backend. The kernel route's sphere test is the half-b quadratic of the JAX
Pallas kernel, whose rounding lets a refracted ray re-hit its own sphere a
little more often than the oracle's full quadratic does: +0.6% to +0.9%
segments against JAX's "woop" on scene 4, hence its wider bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.ops import rebin as jrebin
from raytracer_tpu.ops.integrator import render_sample_mean as jrsm
from raytracer_tpu_torch.ops import integrator as tint
from raytracer_tpu_torch.ops import rebin as trebin
from raytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

PIXEL_ABS = 1e-4
# scene -> (share of pixels within PIXEL_ABS, max mean |d|)
PIXEL_BOUNDS = {1: (0.99, 1e-3), 4: (0.90, 5e-3)}
# (scene, backend) -> max relative segment difference
SEGS_REL = {(1, "woop"): 5e-3, (1, "pallas"): 5e-3, (4, "woop"): 5e-3,
            (4, "pallas"): 1.5e-2}
SIZES = {1: (24, 16, (0.0, 0.0, 0.0)), 4: (64, 32, (0.0, 0.5, -6.0))}


def _setup(num, **settings):
    """Both scenes, settings and the Morton-ordered primary rays."""
    w, h, pos = SIZES[num]
    kw = {"seed": 0} if num == 4 else {}
    js, sky = rt.build_scene(num, **kw)
    ts, _ = rtt.build_scene(num, **kw)
    order = jcam.morton_order(w, h)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=w, height=h, position=pos)),
        w, h, pixel_order=order)
    jset = rt.RenderSettings(**settings).with_sky(sky)
    tset = rtt.RenderSettings(**settings).with_sky(sky)
    return (js, jset, jnp.asarray(order), o, d), (
        ts, tset, torch.from_numpy(np.array(order)),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)))


@pytest.mark.parametrize("backend", ["woop", "pallas"])
@pytest.mark.parametrize("sampler", ["regen", "scan"])
@pytest.mark.parametrize("num", [1, 4])
def test_sampler_matches_jax(num, sampler, backend):
    """Port regen / scan (the oracle backend and the kernel route's plain
    versions) against JAX regen / scan on its "woop" backend."""
    (js, jset, jidx, jo, jd), (ts, tset, tidx, to, td) = _setup(
        num, rays_per_pixel=4, reflect_limit=5, sampler=sampler)
    jm, jsegs = jrsm(js, jset, jidx, jo, jd,
                     jax.random.fold_in(jax.random.key(0), 3),
                     backend="woop")
    tm, tsegs = tint.render_sample_mean(
        ts, tset, to, td, trng.fold_in(trng.key(0), 3), ray_idx=tidx,
        backend=backend)
    assert tm.shape == (to.shape[0], 3) and tsegs.dtype == torch.float64
    assert torch.isfinite(tm).all()
    err = np.abs(tm.numpy() - np.asarray(jm))
    share_min, mean_max = PIXEL_BOUNDS[num]
    assert (err.max(axis=1) <= PIXEL_ABS).mean() >= share_min
    assert err.mean() <= mean_max
    assert abs(float(tsegs) - float(jsegs)) <= \
        SEGS_REL[(num, backend)] * float(jsegs)


def _render(sampler="regen", spp=8, key=3, reflect_limit=5, **kw):
    _, (ts, tset, tidx, to, td) = _setup(1, rays_per_pixel=spp,
                                         reflect_limit=reflect_limit,
                                         sampler=sampler, **kw)
    return tint.render_sample_mean(ts, tset, to, td, trng.key(key),
                                   ray_idx=tidx)


def test_regen_deterministic():
    m1, s1 = _render()
    m2, s2 = _render()
    assert torch.equal(m1, m2) and float(s1) == float(s2)


def test_regen_early_exit_segment_count():
    """Sky-only scene (test_regen.py:54-73): every path is one segment, so
    regen traces exactly n * spp segments and every pixel is the sky."""
    from raytracer_tpu_torch.models.materials import Material, Texture
    from raytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    b.add_sphere((1000, 0, 0), 1.0,
                 Material.standard(Texture.const_colour((1, 1, 1)), 0))
    settings = rtt.RenderSettings(rays_per_pixel=16, reflect_limit=5,
                                  antialias=False, sampler="regen")
    n = 64
    o = torch.zeros(n, 3)
    d = torch.zeros(n, 3)
    d[:, 2] = 1.0
    mean, segs = tint.render_sample_mean(b.build(), settings, o, d,
                                         trng.key(0))
    assert float(segs) == n * 16
    torch.testing.assert_close(mean, torch.tensor([[0.8, 1.0, 1.0]]).expand(
        n, 3), rtol=1e-6, atol=0)


@pytest.mark.parametrize("sampler", ["regen", "scan"])
def test_rr_is_unbiased_and_cheaper(sampler):
    """test_roulette.py:51-67 at 64 spp: russian roulette kills paths in
    the closed Cornell scene and keeps the global mean within Monte-Carlo
    noise (measured at 24x16: segments -28%, channel means within 0.7%;
    the bound is JAX's)."""
    plain, segs_plain = _render(sampler, spp=64, key=7)
    rr, segs_rr = _render(sampler, spp=64, key=7, russian_roulette=2)
    assert float(segs_rr) < 0.9 * float(segs_plain)
    assert torch.isfinite(rr).all()
    for c in range(3):
        m_plain, m_rr = float(plain[:, c].mean()), float(rr[:, c].mean())
        assert abs(m_rr - m_plain) < 0.05 * max(m_plain, 1e-3), (c, m_plain,
                                                                 m_rr)


def test_rr_first_bounces_protected():
    """test_roulette.py:70-81: with russian_roulette >= reflect_limit no
    bounce is eligible, so the render is bitwise the RR-off render."""
    plain, segs_plain = _render(spp=10, reflect_limit=3)
    prot, segs_prot = _render(spp=10, reflect_limit=3, russian_roulette=3)
    assert torch.equal(plain, prot) and float(segs_plain) == float(segs_prot)


@pytest.mark.parametrize("sampler", ["rebin", "lanesort"])
def test_rebin_and_lanesort_bitwise_equal_regen(sampler):
    """test_regen.py:76-93, 141-157: row and ray re-binning permute the
    lanes only; streams ride the permutation, sums are un-permuted."""
    _, (ts, tset, tidx, to, td) = _setup(4, rays_per_pixel=6,
                                         reflect_limit=4, sampler="regen")
    ws = tint.WaveScene(ts)
    key = trng.key(7)
    m_a, s_a = tint.render_sample_mean(ws, tset, to, td, key, ray_idx=tidx)
    m_b, s_b = tint.render_sample_mean(
        ws, dataclasses.replace(tset, sampler=sampler), to, td, key,
        ray_idx=tidx)
    assert torch.equal(m_a, m_b) and float(s_a) == float(s_b)


def test_lane_destinations_match_stable_argsort():
    """test_regen.py:96-123: a permutation that stably sorts by bucket,
    as JAX's counting sort computes it; applying it sorts."""
    g = np.random.default_rng(11)
    n = 128 * 40
    key = g.integers(0, trebin.LANE_BUCKETS, n).astype(np.int32)
    dest = trebin.lane_destinations(torch.from_numpy(key))
    np.testing.assert_array_equal(
        dest.numpy(), np.asarray(jrebin.lane_destinations(jnp.asarray(key))))
    order = np.argsort(key, kind="stable")
    expect = np.empty(n, np.int64)
    expect[order] = np.arange(n)
    np.testing.assert_array_equal(dest.numpy(), expect)
    vals = torch.from_numpy(g.normal(size=(3, n)).astype(np.float32))
    one = torch.from_numpy(g.normal(size=n).astype(np.float32))
    mv = trebin.apply_lane_permutation(dest, [vals, one])
    np.testing.assert_array_equal(mv[1].numpy(), one.numpy()[order])
    np.testing.assert_array_equal(mv[0].numpy(), vals.numpy()[:, order])


def test_buckets_match_jax():
    """Per-ray and per-row buckets bitwise equal to JAX's on seeded rays,
    with done lanes parked far away; the row permutation is JAX's."""
    g = np.random.default_rng(5)
    n = 128 * 16
    o = g.uniform(-5, 5, (3, n)).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    done = g.uniform(size=n) < 0.2
    done[: 3 * 128] = True                      # three fully parked rows
    o[:, done] = 1e13
    d[:, done] = np.array([[1.0], [0.0], [0.0]], np.float32)
    args_j = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(done))
    args_t = (torch.from_numpy(o), torch.from_numpy(d),
              torch.from_numpy(done))
    np.testing.assert_array_equal(trebin.lane_buckets(*args_t).numpy(),
                                  np.asarray(jrebin.lane_buckets(*args_j)))
    rb = jrebin.row_buckets(*args_j)
    np.testing.assert_array_equal(trebin.row_buckets(*args_t).numpy(),
                                  np.asarray(rb))
    np.testing.assert_array_equal(
        trebin.bucket_permutation(torch.from_numpy(np.array(rb))).numpy(),
        np.asarray(jrebin.bucket_permutation(rb)))
    arr = torch.arange(2 * n, dtype=torch.float32).reshape(2, n)
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        trebin.permute_rows(perm, arr).numpy(),
        np.asarray(jrebin.permute_rows(jnp.asarray(perm.numpy()),
                                       jnp.asarray(arr.numpy()))))


def test_lane_buckets_group_coherent_rays():
    """test_regen.py:126-138: two origin cells x two octants -> 4 buckets
    among the live rays."""
    n = 256
    o = torch.zeros(3, n)
    o[:, n // 2:] = 10.0
    d = torch.ones(3, n)
    d[0, ::2] = -1.0
    done = torch.zeros(n, dtype=torch.bool)
    done[:4] = True
    b = trebin.lane_buckets(o, d, done)
    assert len(set(b[4:].tolist())) == 4


@pytest.mark.parametrize("sampler", ["regen", "lanesort"])
def test_renderer_wavefront_frames_image_checkpoint(sampler, tmp_path):
    scene, sky = rtt.build_scene(4, seed=0)
    settings = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=4,
                                  sampler=sampler).with_sky(sky)
    cam = rtt.CameraConfig(width=32, height=32, position=(0.0, 0.5, -6.0))
    r = rtt.Renderer(scene, cam, settings)
    assert r._mega is None
    assert not r.packed_scene.blocked
    rec = r.render_frames(2)
    assert rec["frames"] == 2 and rec["segments"] > 0
    r.check_health()
    assert r.image().shape == (32, 32, 3) and r.image().any()
    # frame 0 is the sampler's mean under frame 0's key, pixel-keyed by
    # the Morton order
    first = rtt.Renderer(scene, cam, settings)
    first.render_frame(block=True)
    mean, _ = tint.render_sample_mean(
        first.packed_scene, settings, first._o, first._d,
        trng.frame_key(first.base_key, 0), ray_idx=first._ray_idx)
    assert torch.equal(first.accum, mean)
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r2 = rtt.Renderer(scene, cam, settings, seed=9)
    r2.load_checkpoint(path)
    r.render_frame(block=True)
    r2.render_frame(block=True)
    assert torch.equal(r.accum, r2.accum)
    fused = rtt.Renderer(scene, cam, settings)
    fused.render_frames(2, fuse=True)
    assert fused.frame_num == 2
    fused.check_health()


def test_unknown_backend_and_sampler_raise():
    _, (ts, tset, tidx, to, td) = _setup(1, rays_per_pixel=1,
                                         sampler="regen")
    with pytest.raises(ValueError, match="backend"):
        tint.render_sample_mean(ts, tset, to, td, trng.key(0),
                                backend="mosaic")
    with pytest.raises(ValueError, match="sampler"):
        rtt.RenderSettings(sampler="bidirectional")
