"""Coherent sampling in raytracer_tpu_torch (``RenderSettings(coherent=
True)``) against raytracer_tpu: the tile draw ``rng.tile_randoms`` and
the coherent ray set-up that draws it (``rays.wave_rays`` keyed by the
tile key), the megakernel's COHERENT arm (``mega_reference``) against
the JAX kernel in Pallas interpret mode, and the regen, rebin and
lanesort samplers' tile-keyed draws; then the estimator's contract (per-pixel marginals unchanged)
and the Renderer on every sampler.

Tolerances. The tile draw's key words and uniforms are bitwise; its
normals go through XLA's erfinv polynomial on both sides and agree within
a few ulps (H8, as test_torch_wavefront_ops.py states). The megakernel is
held to F2's per-pixel quantiles (test_torch_megakernel.py): measured at
64x64, 2 spp, frame 3: 97.1% of pixels within 1e-4 and mean |d| 2.27e-3
with russian roulette off, 98.7% and 2.81e-3 with it on; segments within
0.31%. The wavefront samplers: on scene 1 regen and lanesort equal JAX's
on every pixel; rebin on all but one of 2048 (5.4e-5 mean |d|); scene 4's
glass brings F4's roundings (93.1-93.5% of 64x32 pixels within 1e-4,
mean |d| 4.0e-3-4.3e-3 for regen; rebin and lanesort 92.1%, 6.1e-3 and
5.4e-3).
"""

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
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu.ops.integrator import render_sample_mean as jrsm
from raytracer_tpu_torch.ops import integrator as tint
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

MAX_NORMAL_ULPS = 4
PIXEL_ABS = 1e-4
SEGS_REL = 5e-3
FRAME = 3


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("it", [0, 7])
@pytest.mark.parametrize("tile_offset", [0, 3])
@pytest.mark.parametrize("with_rr", [False, True])
@pytest.mark.parametrize("n", [1000, 4101])
def test_tile_randoms_match_jax(n, with_rr, tile_offset, it):
    """rng.py:104-127 under the regen sampler's key,
    fold_in(fold_in(frame key, tile_offset), it)."""
    jk = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(5), FRAME), tile_offset), it)
    tk = trng.fold_in(trng.fold_in(trng.fold_in(trng.key(5), FRAME),
                                   tile_offset), it)
    np.testing.assert_array_equal(tk, np.asarray(jax.random.key_data(jk)))
    want = jrng.tile_randoms(jk, n, with_rr=with_rr)
    got = trng.tile_randoms(tk, n, with_rr=with_rr, device="cpu")
    assert len(got) == len(want) == (4 if with_rr else 3)
    assert got[0].shape == got[1].shape == (3, n)
    assert got[2].shape == (n,)
    for i in [0, 2] + ([3] if with_rr else []):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert _ulps(got[1].numpy(), want[1]).max() <= MAX_NORMAL_ULPS


@pytest.mark.parametrize("arm", ["host", "device"])
@pytest.mark.parametrize("with_rr", [False, True])
def test_coherent_wave_rays_match_jax(with_rr, arm):
    """The coherent ray set-up (``wave_rays`` keyed by the iteration's tile
    key, from the host or from device memory as a replayed graph reads
    it) against JAX's ``rng.tile_randoms`` under the same key, its
    antialias jitter (scatter.py:34) and the hit kernel's normalisation
    (intersect_pallas.py:737-741), on 4101 lanes: the Fresnel and
    russian-roulette rows bitwise, the normals within H8's 3 ulps, the
    directions within test_torch_wave_rays.py's bounds (1e-6)."""
    from raytracer_tpu.ops import scatter as jscatter
    from raytracer_tpu_torch.ops import rays as trays
    n = 4101
    jk = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(5), FRAME), 3), 7)
    want = jrng.tile_randoms(jk, n, with_rr=with_rr)
    g = np.random.default_rng(8)
    d = g.standard_normal((3, n)).astype(np.float32) * 2.0
    jdj = jscatter.antialias_jitter(want[0], jnp.asarray(d))
    jinv = jax.lax.rsqrt(jnp.sum(jdj * jdj, axis=0))
    tkey = trng.fold_in(trng.fold_in(trng.key(5), FRAME), 3)
    if arm == "host":
        kw = dict(tile_key=trng.fold_in(tkey, 7))
    else:
        key_dev = torch.zeros(2, dtype=torch.int64)
        trng.set_key(key_dev, tkey)
        kw = dict(key_dev=key_dev,
                  iter_dev=torch.tensor([7, 0], dtype=torch.int64))
    got = trays.wave_rays(torch.from_numpy(d), with_rr=with_rr, **kw)
    np.testing.assert_array_equal(got.fresnel.numpy(), np.asarray(want[2]))
    if with_rr:
        np.testing.assert_array_equal(got.rr.numpy(), np.asarray(want[3]))
    assert _ulps(got.gauss.numpy(), want[1]).max() <= 3
    np.testing.assert_allclose(got.dj.numpy(), np.asarray(jdj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.unit.numpy(),
                               np.asarray(jdj * jinv[None, :]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.inv_len.numpy(), np.asarray(jinv),
                               rtol=1e-6, atol=0)


def test_tile_randoms_share_a_tile():
    """Every lane of a 1024-lane tile draws the same bundle; neighbouring
    tiles, other tile offsets and other iterations draw other ones. The
    russian-roulette row comes after the first seven, which it leaves
    unchanged."""
    fkey = trng.fold_in(trng.key(0), 1)
    n = 3 * 1024 + 77

    def rows(tile_offset, it, with_rr=False):
        drawn = trng.tile_randoms(
            trng.fold_in(trng.fold_in(fkey, tile_offset), it), n,
            with_rr=with_rr, device="cpu")
        return torch.cat([drawn[0], drawn[1]] + [x[None] for x in drawn[2:]])

    a = rows(0, 0)
    tiles = [a[:, t * 1024:min(n, (t + 1) * 1024)] for t in range(4)]
    for t in tiles:
        assert torch.equal(t, t[:, :1].expand_as(t))
    for t in range(3):
        assert (tiles[t][:, 0] != tiles[t + 1][:, 0]).all()
    for other in (rows(1, 0), rows(0, 1)):
        assert (other[:, 0] != a[:, 0]).all()
    assert torch.equal(rows(0, 0, with_rr=True)[:7], a)


@functools.lru_cache(maxsize=None)
def _mega_pair(pixpack, rr):
    """(port mean, segs), (JAX mean, segs): scene 4 at 64x64, 2 spp, the
    coherent arm, on the same rays, frame key and packing."""
    js, sky = rt.build_scene(4, seed=0)
    ts, _ = rtt.build_scene(4, seed=0, device="cpu")
    kw = dict(rays_per_pixel=2, reflect_limit=5, antialias=True,
              coherent=True, russian_roulette=rr)
    jset = rt.RenderSettings(**kw).with_sky(sky)
    tset = rtt.RenderSettings(**kw).with_sky(sky)
    w = h = 64
    order = jcam.morton_order(w, h)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=w, height=h)), w, h,
        pixel_order=order)
    o, d = np.asarray(o).T.copy(), np.asarray(d).T.copy()
    jm, jsegs = jmk.render_sample_mean_mega(
        js, jset, o, d, jax.random.fold_in(jax.random.key(0), FRAME),
        pixpack=pixpack)
    tm, tsegs = tmk.render_sample_mean_mega(
        ts, tset, torch.from_numpy(o), torch.from_numpy(d),
        trng.fold_in(trng.key(0), FRAME), pixpack=pixpack)
    return (tm.numpy(), float(tsegs)), (np.asarray(jm), float(jsegs))


@pytest.mark.parametrize("rr", [0, 1])
@pytest.mark.parametrize("pixpack", [1, 2])
def test_coherent_mega_reference_matches_jax_interpret(pixpack, rr):
    (tm, tsegs), (jm, jsegs) = _mega_pair(pixpack, rr)
    assert tm.shape == jm.shape == (3, 64 * 64)
    assert np.isfinite(tm).all()
    err = np.abs(tm - jm)
    assert (err.max(axis=0) <= PIXEL_ABS).mean() >= 0.96
    assert err.mean() <= 3e-3
    assert abs(tsegs - jsegs) <= SEGS_REL * jsegs


def test_coherent_arm_draws_per_tile():
    """The plain kernel's coherent arm: every lane slot of a tile scatters
    with the same direction, so without antialiasing two lanes whose
    primary rays coincide trace the same path; the per-lane arm does
    not."""
    ts, sky = rtt.build_scene(1, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=4,
                           antialias=False).with_sky(sky)
    n = 4096
    o = torch.zeros(3, n)
    d = torch.zeros(3, n)
    d[2] = 1.0
    d[0] = 0.1
    key = trng.key(2)
    coh, _ = tmk.render_sample_mean_mega(
        ts, dataclasses.replace(s, coherent=True), o, d, key)
    per_lane, _ = tmk.render_sample_mean_mega(ts, s, o, d, key)
    assert torch.equal(coh, coh[:, :1].expand_as(coh))
    assert not torch.equal(per_lane, per_lane[:, :1].expand_as(per_lane))


SIZES = {1: (64, 32, (0.0, 0.0, 0.0)), 4: (64, 32, (0.0, 0.5, -6.0))}
# (scene, sampler) -> (share of pixels within PIXEL_ABS, max mean |d|,
# max relative segment difference)
REGEN_BOUNDS = {(1, "regen"): (1.0, 0.0, 0.0),
                (1, "lanesort"): (1.0, 0.0, 0.0),
                (1, "rebin"): (0.99, 1e-3, 5e-3),
                (4, "regen"): (0.90, 5e-3, 1.5e-2),
                (4, "rebin"): (0.90, 8e-3, 1.5e-2),
                (4, "lanesort"): (0.90, 8e-3, 1.5e-2)}


def _setup(num, **settings):
    w, h, pos = SIZES[num]
    kw = {"seed": 0} if num == 4 else {}
    js, sky = rt.build_scene(num, **kw)
    ts, _ = rtt.build_scene(num, **kw, device="cpu")
    order = jcam.morton_order(w, h)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=w, height=h, position=pos)),
        w, h, pixel_order=order)
    jset = rt.RenderSettings(**settings).with_sky(sky)
    tset = rtt.RenderSettings(**settings).with_sky(sky)
    return (js, jset, jnp.asarray(order), o, d), (
        ts, tset, torch.from_numpy(np.array(order)),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)))


@pytest.mark.parametrize("num,sampler", sorted(REGEN_BOUNDS))
def test_coherent_wavefront_matches_jax(num, sampler):
    """The port's kernel route (plain versions on the CPU) against JAX's
    "woop" backend, coherent, tile_offset 2, two 1024-lane tiles: the
    draws belong to the lane position, so rebin and lanesort move lanes
    between tiles' draws exactly as JAX's do."""
    (js, jset, jidx, jo, jd), (ts, tset, tidx, to, td) = _setup(
        num, rays_per_pixel=4, reflect_limit=5, sampler=sampler,
        coherent=True)
    jm, jsegs = jrsm(js, jset, jidx, jo, jd,
                     jax.random.fold_in(jax.random.key(0), FRAME),
                     backend="woop", tile_offset=2)
    tm, tsegs = tint.render_sample_mean(
        ts, tset, to, td, trng.fold_in(trng.key(0), FRAME), ray_idx=tidx,
        tile_offset=2)
    assert torch.isfinite(tm).all()
    err = np.abs(tm.numpy() - np.asarray(jm))
    share_min, mean_max, segs_rel = REGEN_BOUNDS[(num, sampler)]
    assert (err.max(axis=1) <= PIXEL_ABS).mean() >= share_min
    assert err.mean() <= mean_max
    assert abs(float(tsegs) - float(jsegs)) <= segs_rel * float(jsegs)


def test_coherent_rebin_and_lanesort_differ_from_regen():
    """Without coherent sampling rebin and lanesort are bitwise regen; with
    it they are not, since only the per-pixel keys ride the permutation
    (integrator.py:271-274)."""
    _, (ts, tset, tidx, to, td) = _setup(1, rays_per_pixel=4,
                                         reflect_limit=5, sampler="regen",
                                         coherent=True)
    ws = tint.WaveScene(ts)
    key = trng.key(3)
    regen, _ = tint.render_sample_mean(ws, tset, to, td, key, ray_idx=tidx)
    for sampler in ("rebin", "lanesort"):
        other, _ = tint.render_sample_mean(
            ws, dataclasses.replace(tset, sampler=sampler), to, td, key,
            ray_idx=tidx)
        assert not torch.equal(other, regen)


FRAMES = 8
SIGMA = 4.0


@pytest.mark.parametrize("sampler", ["mega", "regen"])
def test_coherent_marginals_unchanged(sampler):
    """Each pixel's estimator is unchanged (rng.py:110-117): over FRAMES
    frames of 16 spp on scene 1 (24x16), the per-pixel means of the
    coherent and per-lane samplers agree within SIGMA standard errors
    (from the frames' spread) on >= 99% of pixel-channels, and the image
    means within SIGMA. Measured: 99.91% (mega; one pixel-channel at
    4.006 sigma) and 100% (regen), image means 0.69 and 0.13 standard
    errors apart."""
    ts, sky = rtt.build_scene(1, device="cpu")
    w, h = 24, 16
    from raytracer_tpu_torch.models import camera as tcam
    cam = tcam.build_camera(rtt.CameraConfig(width=w, height=h))
    o, d = tcam.primary_rays(cam, w, h,
                             pixel_order=tcam.morton_order(w, h), device="cpu")
    out = {}
    for coherent in (False, True):
        s = rtt.RenderSettings(rays_per_pixel=16, reflect_limit=5,
                               sampler=sampler,
                               coherent=coherent).with_sky(sky)
        out[coherent] = torch.stack([
            tint.render_sample_mean(ts, s, o, d,
                                    trng.frame_key(trng.key(11), f))[0]
            for f in range(FRAMES)]).double()        # (F, N, 3)
    (a, b) = out[False], out[True]
    se = torch.sqrt((a.var(dim=0) + b.var(dim=0)) / FRAMES).clamp(min=1e-6)
    z = (a.mean(dim=0) - b.mean(dim=0)).abs() / se
    assert float((z <= SIGMA).double().mean()) >= 0.99
    ia, ib = a.mean(dim=(1, 2)), b.mean(dim=(1, 2))
    se_img = torch.sqrt((ia.var() + ib.var()) / FRAMES)
    assert float((ia.mean() - ib.mean()).abs() / se_img) <= SIGMA
    assert not torch.equal(a, b)


@pytest.mark.parametrize("sampler,temporal", [
    ("auto", False), ("mega", False), ("regen", False), ("rebin", False),
    ("lanesort", False), ("auto", True)])
def test_renderer_renders_coherent(sampler, temporal):
    """RenderSettings(coherent=True) renders through Renderer on every
    sampler that JAX draws coherently, and in temporal mode (the
    megakernel with depth), on the CPU."""
    scene, sky = rtt.build_scene(4, seed=0, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=3,
                           sampler=sampler, coherent=True).with_sky(sky)
    cam = rtt.CameraConfig(width=48, height=32, position=(0.0, 0.5, -6.0))
    r = rtt.Renderer(scene, cam, s, device="cpu", temporal=temporal)
    assert r.settings.coherent
    r.render_frame(block=True)
    if temporal:
        r.move_camera(dataclasses.replace(cam, y_rot=0.02))
        r.render_frame(block=True)
    r.check_health()
    assert r.total_segments > 0 and r.image().any()
    plain = rtt.Renderer(scene, cam, dataclasses.replace(s, coherent=False),
                         device="cpu", temporal=temporal)
    plain.render_frame(block=True)
    if temporal:
        plain.move_camera(dataclasses.replace(cam, y_rot=0.02))
        plain.render_frame(block=True)
    assert not torch.equal(plain.accum, r.accum)
