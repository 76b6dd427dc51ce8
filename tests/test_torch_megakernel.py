"""raytracer_tpu_torch megakernel sampler: the plain version
(``mega_reference``) against raytracer_tpu's megakernel in Pallas interpret
mode, per pixel, on scene 4.

Off the TPU the JAX kernel draws its randoms from a counter hash
(megakernel.py:406-417, 560-571); the port evaluates the same hash, so both
sides trace every pixel with the same random bits, and a pixel differs only
where float rounding sends a path another way. The two sides round
differently: XLA on the CPU fuses products into FMAs and its rsqrt, sin and
cos are not torch's. A path that turns off at a silhouette or a Fresnel
branch changes its pixel by up to the whole radiance, so the bounds are per
pixel quantiles. For scale: the JAX kernel against itself with the primary
directions moved by one ulp keeps 98.7% of the 64x64 pixels within 1e-4
(mean |d| 8.4e-4), about what the port keeps here.

The CUDA kernel is held against ``mega_reference`` on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import functools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import camera as jcam
from raytracer_tpu.ops import megakernel as jmk
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(2)

PIXEL_ABS = 1e-4
# (width, height, pixpack, antialias) -> (share of pixels within PIXEL_ABS,
# max mean |d radiance|). Measured over frames 0, 1, 3, 5, 7: 97.3-98.0%
# and 1.5e-3-2.3e-3 at 64x64; 95.7-96.0% and 3.9e-3-4.2e-3 at 128x64,
# whose left half is mostly glass spheres.
CASES = {
    (64, 64, 1, True): (0.96, 3e-3),
    (128, 64, 2, True): (0.94, 6e-3),
}
SEGS_REL = 5e-3
FRAME = 3


@functools.lru_cache(maxsize=None)
def _render_pair(width, height, pixpack, antialias):
    """(port mean, segs, depth), (JAX mean, segs, depth) on the same rays,
    frame key and pixel packing; both scenes from their default BVH build,
    which is the same in both packages (test_torch_scene.py)."""
    js, sky = rt.build_scene(4, seed=0)
    ts, _ = rtt.build_scene(4, seed=0, device="cpu")
    kw = dict(rays_per_pixel=2, reflect_limit=5, antialias=antialias)
    jset = rt.RenderSettings(**kw).with_sky(sky)
    tset = rtt.RenderSettings(**kw).with_sky(sky)
    order = jcam.morton_order(width, height)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=width, height=height)),
        width, height, pixel_order=order)
    o, d = np.asarray(o).T.copy(), np.asarray(d).T.copy()
    jkey = jax.random.fold_in(jax.random.key(0), FRAME)
    jm, js_, jd = jmk.render_sample_mean_mega(
        js, jset, o, d, jkey, want_depth=True, pixpack=pixpack)
    tm, ts_, td = tmk.render_sample_mean_mega(
        ts, tset, torch.from_numpy(o), torch.from_numpy(d),
        trng.fold_in(trng.key(0), FRAME), want_depth=True, pixpack=pixpack)
    return ((tm.numpy(), float(ts_), td.numpy()),
            (np.asarray(jm), float(js_), np.asarray(jd)))


@pytest.mark.parametrize("case", sorted(CASES),
                         ids=lambda c: f"{c[0]}x{c[1]}-pixpack{c[2]}")
def test_mega_reference_matches_jax_interpret(case):
    share_min, mean_max = CASES[case]
    (tm, tsegs, td), (jm, jsegs, jd) = _render_pair(*case)
    assert tm.shape == jm.shape == (3, case[0] * case[1])
    assert np.isfinite(tm).all()
    err = np.abs(tm - jm)
    assert (err.max(axis=0) <= PIXEL_ABS).mean() >= share_min
    assert err.mean() <= mean_max
    assert abs(tsegs - jsegs) <= SEGS_REL * jsegs
    # primary hit or miss agrees on every pixel
    np.testing.assert_array_equal(td < tmk.INF, jd < jmk._INF)


def test_depth_matches_jax_without_antialias():
    """Primary-hit depth with no jitter: the same hit on every pixel; t is
    not bitwise equal because the wrapper's rsqrt and XLA's FMAs round
    differently, so it is held within 1e-3 of max(1, t)."""
    (tm, _, td), (jm, _, jd) = _render_pair(64, 64, 1, False)
    hit = jd < jmk._INF
    np.testing.assert_array_equal(td < tmk.INF, hit)
    assert 0.3 < hit.mean() < 1.0
    err = np.abs(td - jd)[hit] / np.maximum(1.0, jd[hit])
    assert err.max() <= 1e-3
    assert np.median(err) <= 1e-6


def test_mesh_scene0_matches_jax_interpret():
    """Scene 0: the Cornell box, the stand-in mesh (80 triangles, so the
    triangle pool is cut into BVH leaf clusters) and a mirror sphere.
    Measured at 64x64 (frames 0, 1, 3, 5, pixpack 1 and 2): every pixel
    equal, as on scene 2 (test_torch_textures.py), since flat walls keep
    a radiance a product of quantised colours; held to the bounds here."""
    js, sky = rt.build_scene(0)
    ts, _ = rtt.build_scene(0, device="cpu")
    assert ts.tri_clusters.shape[0] > 0
    s = dict(rays_per_pixel=2, reflect_limit=5, antialias=True)
    w = h = 32
    order = jcam.morton_order(w, h)
    o, d = jcam.primary_rays(
        jcam.build_camera(rt.CameraConfig(width=w, height=h)), w, h,
        pixel_order=order)
    o, d = np.asarray(o).T.copy(), np.asarray(d).T.copy()
    jm, jsegs = jmk.render_sample_mean_mega(
        js, rt.RenderSettings(**s).with_sky(sky), o, d,
        jax.random.fold_in(jax.random.key(0), FRAME), pixpack=2)
    tm, tsegs = tmk.render_sample_mean_mega(
        ts, rtt.RenderSettings(**s).with_sky(sky), torch.from_numpy(o),
        torch.from_numpy(d), trng.fold_in(trng.key(0), FRAME), pixpack=2)
    err = np.abs(tm.numpy() - np.asarray(jm))
    assert np.isfinite(tm.numpy()).all() and float(tm.mean()) > 0.05
    assert (err.max(axis=0) <= PIXEL_ABS).mean() >= 0.99
    assert err.mean() <= 1e-3
    assert abs(float(tsegs) - float(jsegs)) <= SEGS_REL * float(jsegs)


def test_cpu_render_launches_no_kernel():
    before = trace.counts()
    _render_pair(64, 64, 1, True)
    ts, sky = rtt.build_scene(4, seed=0, device="cpu")
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=2).with_sky(sky)
    o = torch.zeros(3, 100)
    d = torch.zeros(3, 100)
    d[2] = 1.0
    mean, segs = tmk.render_sample_mean_mega(ts, s, o, d, trng.key(0))
    assert mean.shape == (3, 100) and segs.dtype == torch.float64
    s2, _ = rtt.build_scene(2, device="cpu")
    mean, _ = tmk.render_sample_mean_mega(s2, s, o, d, trng.key(0))
    assert torch.isfinite(mean).all()
    assert trace.counts() == before


def test_wrapper_rejects_bad_inputs():
    ts, _ = rtt.build_scene(4, seed=0, device="cpu")
    ms = tmk.MegaScene(ts)
    s = rtt.RenderSettings(rays_per_pixel=1)
    o = torch.zeros(3, 10)
    key = trng.key(0)
    with pytest.raises(ValueError):
        tmk.render_sample_mean_mega(ms, s, o.T, o.T, key)
    with pytest.raises(ValueError):
        tmk.render_sample_mean_mega(ms, s, o.double(), o.double(), key)
    with pytest.raises(ValueError):
        tmk.render_sample_mean_mega(ms, s, o, o[:, :5], key)
    with pytest.raises(ValueError):
        tmk.render_sample_mean_mega(ms, s, o, o, key, pixpack=0)
    with pytest.raises(ValueError):
        tmk.render_sample_mean_mega(ms, s, o.to("meta"), o.to("meta"), key)


def test_pad_rays_and_layout():
    """Padding to whole tiles of 4096 * pixpack with o = 0, d = (1, 0, 0)
    (megakernel.py:1189-1197), then unit directions."""
    g = np.random.default_rng(0)
    o = torch.from_numpy(g.normal(size=(3, 5000)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(3, 5000)).astype(np.float32))
    for k in (1, 2, 8):
        op, dp = tmk.pad_rays(o, d, k)
        tile = tmk.MEGA_TILE * k
        assert op.shape[1] % tile == 0 and op.shape[1] >= max(tile, 5000)
        assert op.is_contiguous() and dp.is_contiguous()
        assert not op[:, 5000:].any()
        assert (dp[0, 5000:] == 1).all() and not dp[1:, 5000:].any()
        torch.testing.assert_close(dp.norm(dim=0), torch.ones(op.shape[1]))
    assert tmk.mega_tile_for(None) == jmk.MEGA_TILE
    assert tmk.resolve_pixpack(rtt.RenderSettings(pixpack=4)) == 4
    assert tmk.resolve_pixpack(rtt.RenderSettings(pixpack=4), 2) == 2
    assert tmk.resolve_pixpack(rtt.RenderSettings()) == 1


CSRC = pathlib.Path(tmk.__file__).resolve().parents[1] / "csrc"


def _c_struct_fields(src: str, name: str) -> list:
    """Field names of ``struct name { ... };`` in declaration order."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        for part in decl.split(","):
            token = part.split()[-1].lstrip("*")
            names.append(re.sub(r"\[\d+\]", "", token))
    return names


def test_kernel_sources_and_binding_without_nvcc():
    """The build module imports without nvcc, the sources are in the
    checkout, and the ctypes argument structs match the C structs field
    by field (the C ABI cannot be exercised here)."""
    from raytracer_tpu_torch.kernels import build
    src = (CSRC / "megakernel.cu").read_text()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert build.library_path().parent == build.BUILD_DIR
    for entry in ("rt_megakernel", "rt_nearest_hit", "rt_fetch_image",
                  "rt_error_string"):
        assert re.search(r"\b%s\(" % entry, src)
    for c_name, py in (("RtScene", build.SceneArgs),
                       ("RtHitArgs", build.HitArgs),
                       ("RtMegaArgs", build.MegaArgs),
                       ("RtFetchArgs", build.FetchArgs)):
        assert _c_struct_fields(src, c_name) == [f[0] for f in py._fields_]
