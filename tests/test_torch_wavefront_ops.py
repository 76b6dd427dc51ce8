"""raytracer_tpu_torch's wavefront building blocks against raytracer_tpu on
numpy-seeded inputs: the per-lane random streams (ops/rng.py), the material
lookup (ops/tables.py), texture sampling (ops/textures.py), scattering
(ops/scatter.py) and the XLA intersection oracles (ops/intersect.py).

Tolerances. Key words and uniforms are bitwise. Normals go through XLA's
erfinv polynomial on both sides, but XLA's log1p and its fused multiply-adds
round differently from torch's: they agree on ~95% of draws and within
MAX_NORMAL_ULPS (3 measured). Scatter normalises with rsqrt, which torch and
XLA round differently (ROADMAP F2), so directions agree within DIR_ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.ops import intersect as jint
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu.ops import scatter as jscatter
from raytracer_tpu.ops import tables as jtables
from raytracer_tpu.ops import textures as jtextures
from raytracer_tpu_torch.ops import intersect as tint
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.ops import scatter as tscatter
from raytracer_tpu_torch.ops import tables as ttables
from raytracer_tpu_torch.ops import textures as ttextures

torch.set_num_threads(2)

MAX_NORMAL_ULPS = 4
DIR_ATOL = 1e-5
N = 4096


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture(scope="module")
def keys():
    idx = np.random.default_rng(0).integers(0, 2 ** 31, N).astype(np.int32)
    jk = jrng.per_ray_keys(jax.random.fold_in(jax.random.key(7), 3),
                           jnp.asarray(idx))
    tk = trng.per_ray_keys(trng.fold_in(trng.key(7), 3),
                           torch.from_numpy(idx))
    return jk, tk


def test_per_ray_keys_bitwise(keys):
    jk, tk = keys
    assert tk.shape == (2, N) and tk.dtype == torch.int64
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jk)).T.astype(np.int64), tk.numpy())
    np.testing.assert_array_equal(
        trng.sample_key(trng.key(3), 5),
        np.asarray(jax.random.key_data(jrng.sample_key(jax.random.key(3),
                                                       5))))


@pytest.mark.parametrize("with_rr", [False, True])
def test_lane_randoms_match_jax(keys, with_rr):
    jk, tk = keys
    g = np.random.default_rng(1)
    s = g.integers(0, 100, N).astype(np.int32)
    b = g.integers(0, 6, N).astype(np.int32)
    want = jrng.lane_randoms(jk, jnp.asarray(s), jnp.asarray(b),
                             with_rr=with_rr)
    got = trng.lane_randoms(tk, torch.from_numpy(s), torch.from_numpy(b),
                            with_rr=with_rr)
    assert len(got) == len(want) == (4 if with_rr else 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if with_rr:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    ulps = _ulps(got[1].numpy(), want[1])
    assert ulps.max() <= MAX_NORMAL_ULPS
    assert (ulps == 0).mean() > 0.9


@pytest.mark.parametrize("with_rr", [False, True])
def test_bounce_randoms_match_jax(keys, with_rr):
    jk, tk = keys
    want = jrng.bounce_randoms(jk, 3, with_rr=with_rr)
    got = trng.bounce_randoms(tk, 3, with_rr=with_rr)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if with_rr:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert _ulps(got[1].numpy(), want[1]).max() <= MAX_NORMAL_ULPS


def test_rr_streams_unchanged_when_off(keys):
    """The port's version of test_roulette.py:33-48: the first seven draws
    are the same with and without the russian-roulette draw, which is a
    stream of its own."""
    _, tk = keys
    plain = trng.bounce_randoms(tk, 2)
    with_rr = trng.bounce_randoms(tk, 2, with_rr=True)
    for a, b in zip(plain, with_rr[:3]):
        assert torch.equal(a, b)
    assert not torch.equal(with_rr[3], plain[2])


def test_lane_randoms_checks_inputs(keys):
    _, tk = keys
    b = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(ValueError):
        trng.lane_randoms(tk.to(torch.int32), None, b)
    with pytest.raises(ValueError):
        trng.lane_randoms(tk, None, b[:10])
    before = trng.LAUNCHES
    trng.lane_randoms(tk, b, b)
    assert trng.LAUNCHES == before      # CPU tensors take the plain version


def _texture_scenes():
    """The same materials in both packages: const, gradient, checker and
    two images, plus glass and a light."""
    out = []
    for pkg in (rt, rtt):
        from importlib import import_module
        mats = import_module(pkg.__name__ + ".models.materials")
        scenes = import_module(pkg.__name__ + ".models.scenes")
        M, T = mats.Material, mats.Texture
        b = import_module(pkg.__name__ + ".models.scene").SceneBuilder()
        img = scenes.procedural_earth_texture(40)
        b.add_sphere((0, 0, 3), 0.5, M.standard(T.const_colour((0.2, 0.4,
                                                                0.6)), 0.5))
        b.add_sphere((1, 0, 3), 0.5, M.standard(T.gradient(), 0.1))
        b.add_sphere((2, 0, 3), 0.5, M.standard(
            T.checkerboard((1, 0.5, 0), (0, 0.2, 0.9), 7), 0))
        b.add_sphere((3, 0, 3), 0.5, M.standard(T.from_image(img), 0))
        b.add_sphere((4, 0, 3), 0.5, M.standard(T.from_image(img[:13, :30]),
                                                0))
        b.add_sphere((5, 0, 3), 0.5, M.refractive(T.const_colour((1, 1, 1)),
                                                  1.5))
        b.add_sphere((6, 0, 3), 0.5, M.emissive((1, 0.75, 0.5), 4.0))
        out.append(b.build())
    return out


def test_lookup_material_matches_jax():
    js, ts = _texture_scenes()
    m = int(ts.mat_type.shape[0])
    ids = np.random.default_rng(2).integers(0, m, 1000).astype(np.int32)
    want = jtables.lookup_material(js, jnp.asarray(ids))
    got = ttables.lookup_material(ts, torch.from_numpy(ids))
    for f in ("mat_type", "ior", "emit", "tex_type", "tex_light",
              "tex_dark", "tex_nsq", "tex_off", "tex_w", "tex_h"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_sample_texture_matches_jax():
    """All four texture types, UVs inside and outside [0, 1], NaN and
    infinities, bitwise."""
    js, ts = _texture_scenes()
    g = np.random.default_rng(3)
    n = 4000
    ids = g.integers(0, int(ts.mat_type.shape[0]), n).astype(np.int32)
    u = g.uniform(-0.1, 1.1, n).astype(np.float32)
    v = g.uniform(-0.1, 1.1, n).astype(np.float32)
    u[:4] = [np.nan, np.inf, -np.inf, 1e9]
    base = g.uniform(0, 1, (3, n)).astype(np.float32)
    want = jtextures.sample_texture(
        js, jtables.lookup_material(js, jnp.asarray(ids)), jnp.asarray(u),
        jnp.asarray(v), jnp.asarray(base))
    got = ttextures.sample_texture(
        ts, ttables.lookup_material(ts, torch.from_numpy(ids)),
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(base))
    assert set(np.asarray(js.tex_type).tolist()) == {0, 1, 2, 3}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scatter_inputs(n=4096, seed=4):
    g = np.random.default_rng(seed)

    def unit(shape):
        x = g.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=0, keepdims=True)

    return dict(
        gauss=g.standard_normal((3, n)).astype(np.float32),
        fresnel_u=g.uniform(0, 1, n).astype(np.float32),
        d=unit((3, n)), normal=unit((3, n)),
        mat_type=g.integers(0, 3, n).astype(np.int32),
        smoothness=g.uniform(0, 1, n).astype(np.float32),
        mat_ior=g.choice([1.0, 1.5, 2.4], n).astype(np.float32),
        cur_ior=g.choice([1.0, 1.5], n).astype(np.float32))


@pytest.mark.parametrize("fix_exit_ior", [False, True])
@pytest.mark.parametrize("has_refractive", [True, False])
def test_scatter_matches_jax(fix_exit_ior, has_refractive):
    kw = _scatter_inputs()
    want_d, want_ior = jscatter.scatter(
        **{k: jnp.asarray(x) for k, x in kw.items()},
        fix_exit_ior=fix_exit_ior, has_refractive=has_refractive)
    got_d, got_ior = tscatter.scatter(
        **{k: torch.from_numpy(x) for k, x in kw.items()},
        fix_exit_ior=fix_exit_ior, has_refractive=has_refractive)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=DIR_ATOL)
    np.testing.assert_array_equal(got_ior.numpy(), np.asarray(want_ior))


def test_antialias_jitter_matches_jax():
    kw = _scatter_inputs()
    u3 = np.random.default_rng(5).uniform(0, 1, (3, 4096)).astype(np.float32)
    want = jscatter.antialias_jitter(jnp.asarray(u3), jnp.asarray(kw["d"]))
    got = tscatter.antialias_jitter(torch.from_numpy(u3),
                                    torch.from_numpy(kw["d"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _rays(n, seed, scene):
    """Origins uniform in the box of the scene's sphere centres and
    triangle corners, directions uniform on the sphere."""
    pts = np.concatenate([scene.sph_center.numpy(), scene.tri_v0.numpy()])
    g = np.random.default_rng(seed)
    o = g.uniform(pts.min(axis=0), pts.max(axis=0), (n, 3)).T
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("num", [1, 4])
@pytest.mark.parametrize("backend", ["xla", "woop"])
def test_oracles_match_jax(num, backend):
    """The port's XLA oracles: the same winner on every ray, t and the
    resolved shading within float rounding (torch's matmul and XLA's dot
    sum in another order)."""
    js, _ = rt.build_scene(num, seed=0) if num == 4 else rt.build_scene(num)
    ts, _ = rtt.build_scene(num, seed=0) if num == 4 else \
        rtt.build_scene(num)
    o, d = _rays(2048, 7, ts)
    jr = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), js,
                          backend=backend)
    tr = tint.nearest_hit(torch.from_numpy(o), torch.from_numpy(d), ts,
                          backend=backend)
    hit = np.asarray(jr.hit)
    assert 0.1 < hit.mean() < 0.95
    np.testing.assert_array_equal(tr.hit.numpy(), hit)
    np.testing.assert_array_equal(tr.idx.numpy()[hit],
                                  np.asarray(jr.idx)[hit])
    np.testing.assert_array_equal(tr.is_tri.numpy()[hit],
                                  np.asarray(jr.is_tri)[hit])
    np.testing.assert_allclose(tr.t.numpy()[hit], np.asarray(jr.t)[hit],
                               rtol=1e-5, atol=1e-5)
    js_ = jint.resolve_hit(jnp.asarray(o), jnp.asarray(d), js, jr)
    ts_ = tint.resolve_hit(torch.from_numpy(o), torch.from_numpy(d), ts, tr)
    for f, tol in (("point", 1e-4), ("normal", 1e-4), ("u", 1e-4),
                   ("v", 1e-4), ("colour", 0), ("smooth", 0)):
        np.testing.assert_allclose(
            getattr(ts_, f).numpy()[..., hit],
            np.asarray(getattr(js_, f))[..., hit], rtol=0, atol=tol,
            err_msg=f)
    np.testing.assert_array_equal(ts_.mat_id.numpy()[hit],
                                  np.asarray(js_.mat_id)[hit])


def test_oracles_refuse_cuda_rays():
    ts, _ = rtt.build_scene(1)
    o = torch.zeros(3, 4, device="meta")
    with pytest.raises(ValueError):
        tint.nearest_hit(o, o, ts)
    with pytest.raises(ValueError):
        tint.nearest_hit(torch.zeros(3, 4), torch.ones(3, 4), ts,
                         backend="pallas")
