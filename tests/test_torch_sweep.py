"""raytracer_tpu_torch nearest hit (the plain version of rt_nearest_hit)
against raytracer_tpu's wavefront oracle, ops/intersect.nearest_hit +
resolve_hit, on numpy-seeded rays over scene 4.

Tolerances. The port keeps the megakernel sweep's arithmetic (sweep.py):
the half-b sphere quadratic over precomputed |c|^2 - r^2, and Woop
triangles with the FAST_DIV reciprocal. The oracle solves the sphere
quadratic about o - c and divides exactly. The half-b form takes h^2 - c as
a difference of terms of size |o|^2, so for rays that start metres from the
world origin a sphere t can move by ~1e-4 of max(1, t); triangle t moves by
the Newton-refined reciprocal's ~2^-17. The winner (code), its material,
colour and smoothness must agree on every ray of this sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.ops import intersect as jint
from raytracer_tpu_torch.ops import sweep as tsweep
from raytracer_tpu_torch.runtime import loader as tloader

torch.set_num_threads(2)

N_RAYS = 4096
SPHERE_T_MAX = 1e-3      # max |dt| / max(1, t) over sphere hits
SPHERE_T_Q99 = 1e-4      # ... 99th percentile
TRIANGLE_T_MAX = 5e-5    # max |dt| / max(1, t) over triangle hits
UV_ABS = 1e-4            # texture UV of triangle winners


@pytest.fixture
def same_bvh():
    """Same primitive order on both sides: both packages take their
    native BVH build where g++ builds it (see test_torch_scene.py)."""
    from test_torch_scene import jax_native_loaded
    assert jax_native_loaded() == tloader.native_available()


def _rays(seed=0, n=N_RAYS):
    """Half random rays through the scene box, half camera rays."""
    g = np.random.default_rng(seed)
    m = n // 2
    o = np.stack([g.uniform(-6, 6, m), g.uniform(-1.5, 3.0, m),
                  g.uniform(-2, 11, m)])
    d = g.standard_normal((3, m))
    o2 = np.zeros((3, n - m))
    d2 = np.stack([g.uniform(-0.6, 0.6, n - m), g.uniform(-0.5, 0.3, n - m),
                   np.ones(n - m)])
    o = np.concatenate([o, o2], axis=1).astype(np.float32)
    d = np.concatenate([d, d2], axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def test_nearest_hit_matches_wavefront_oracle(same_bvh):
    js, _ = rt.build_scene(4, seed=0)
    ts, _ = rtt.build_scene(4, seed=0)
    o, d = _rays()
    rec = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), js)
    shade = jint.resolve_hit(jnp.asarray(o), jnp.asarray(d), js, rec)
    t, code, u, v, n0, n1, n2, pa, pb = (
        x.numpy() for x in tsweep.nearest_hit(
            tsweep.pack(ts), torch.from_numpy(o), torch.from_numpy(d)))

    hit = np.asarray(rec.hit)
    is_tri = np.asarray(rec.is_tri) & hit
    idx = np.asarray(rec.idx)
    assert 0.2 < hit.mean() < 0.9 and is_tri.sum() > 100
    np.testing.assert_array_equal(code, np.where(hit, idx * 2 + is_tri, 0))
    np.testing.assert_array_equal(t >= tsweep.INF, ~hit)

    jt = np.asarray(rec.t)
    err = np.abs(t - jt) / np.maximum(1.0, np.abs(jt))
    sph = hit & ~is_tri
    assert err[sph].max() <= SPHERE_T_MAX
    assert np.quantile(err[sph], 0.99) <= SPHERE_T_Q99
    assert err[is_tri].max() <= TRIANGLE_T_MAX

    # winner parameters: material, colour, smoothness bitwise
    np.testing.assert_array_equal((pb & 0xFFFF)[hit],
                                  np.asarray(shade.mat_id)[hit])
    col = np.stack([c.numpy() for c in tsweep.decode_colour30(
        torch.from_numpy(pa))])
    np.testing.assert_array_equal(col[:, hit], np.asarray(shade.colour)[:, hit])
    smooth = tsweep.decode_smooth_mat(torch.from_numpy(pb))[0].numpy()
    np.testing.assert_array_equal(smooth[hit], np.asarray(shade.smooth)[hit])
    # centre (spheres) or unflipped geometric normal (triangles)
    nrm = np.stack([n0, n1, n2])
    np.testing.assert_array_equal(
        nrm[:, sph].T, np.asarray(js.sph_center)[idx[sph]])
    np.testing.assert_array_equal(
        nrm[:, is_tri].T, np.asarray(js.tri_normal)[idx[is_tri]])
    # texture UV of triangle winners; 0 for spheres (the megakernel
    # computes sphere UVs itself)
    assert np.abs(u[is_tri] - np.asarray(shade.u)[is_tri]).max() <= UV_ABS
    assert np.abs(v[is_tri] - np.asarray(shade.v)[is_tri]).max() <= UV_ABS
    assert not u[sph].any() and not v[sph].any()


def test_fast_recip_is_interpret_mode_reciprocal():
    """Hazard H2: the FAST_DIV reciprocal the JAX megakernel evaluates in
    Pallas interpret mode (sweep.py:984-986). The approximate reciprocal is
    bit for bit; after the Newton step XLA fuses ``2 - dw * r0`` into one
    FMA where the port rounds the product first, so the refined value
    agrees to two ulps."""
    g = np.random.default_rng(3)
    x = (g.standard_normal((64, 128)) * np.exp(
        g.uniform(-8, 8, (64, 128)))).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1.0, -3.0]

    def kernel(x_ref, r0_ref, o_ref):
        dw = x_ref[...]
        r0 = pl.reciprocal(dw, approx=True)
        r0_ref[...] = r0
        o_ref[...] = r0 * (2.0 - dw * r0)

    shape = jax.ShapeDtypeStruct(x.shape, jnp.float32)
    want_r0, want = pl.pallas_call(kernel, out_shape=(shape, shape),
                                   interpret=True)(x)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tsweep.approx_reciprocal(xt).numpy(),
                                  np.asarray(want_r0))
    got = tsweep.fast_recip(xt).numpy()
    want = np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[finite], want[finite], rtol=2.0 ** -22,
                               atol=0)


def test_nearest_hit_wrapper_checks_and_counts():
    ts, _ = rtt.build_scene(4, seed=0)
    ps = tsweep.pack(ts)
    o, d = (torch.from_numpy(a) for a in _rays(n=256))
    before = tsweep.LAUNCHES
    out = tsweep.nearest_hit(ps, o, d)
    assert tsweep.LAUNCHES == before   # CPU tensors take the plain version
    assert [x.dtype for x in out] == [torch.float32, torch.int32] + [
        torch.float32] * 5 + [torch.int32] * 2
    assert all(x.shape == (256,) for x in out)
    with pytest.raises(ValueError):
        tsweep.nearest_hit(ps, o.T, d.T)
    with pytest.raises(ValueError):
        tsweep.nearest_hit(ps, o.double(), d.double())
    with pytest.raises(ValueError):
        tsweep.nearest_hit(ps, o, d[:, :128])
    with pytest.raises(ValueError):
        tsweep.nearest_hit(ps, o.to("meta"), d.to("meta"))


def test_leaf_size_matches_jax():
    from raytracer_tpu.ops import sweep as jsweep
    for n in (1, 4, 8, 31, 32, 33, 104, 112, 1000):
        assert tsweep.leaf_size(n) == jsweep.leaf_size(n)
