"""K5's primitive-test counters in raytracer_tpu_torch
(``intersect_cuda.intersection_stats``, the ``with_stats`` arm of
``rt_hit_resolve``) against raytracer_tpu's ``intersection_stats``
(intersect_pallas.py:909-919) in Pallas interpret mode.

Both count, per ray, the primitives of every leaf cluster the ray enters
before its best t, plus the whole pool where a pool has no clusters. JAX's
tile enters a cluster when any lane does, but counts per lane, and a lane
that misses a box cannot improve its best t there; so on a scene walked in
index order the counts are equal per ray. Scenes with a per-cell cluster
order (``sph_cell_order.shape[0] > 1``) are walked near-first by JAX and in
index order by the port (ROADMAP H3), so the counts differ where the visit
order changes a ray's best t early: measured on test_pallas.py's 1500-sphere
scene, 8 of 256 rays differ and the means are 79.33 (JAX) and 80.20 (port).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.models import materials as jmat
from raytracer_tpu.models import scene as jscene
from raytracer_tpu.ops.intersect_pallas import intersection_stats as jstats
from raytracer_tpu_torch.models import materials as tmat
from raytracer_tpu_torch.models import scene as tscene
from raytracer_tpu_torch.ops import intersect_cuda as ic
from raytracer_tpu_torch.ops import sweep as tsweep
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(2)

N_RAYS = 256


def _spheres(mat_mod, scene_mod, n, seed, bulk):
    """test_pallas.py's random sphere fields: 600 spheres one by one
    (test_intersection_stats_with_clusters, :123) or 1500 in bulk with
    colours (test_cell_ordered_traversal_matches_oracle, :144)."""
    g = np.random.default_rng(seed)
    b = scene_mod.SceneBuilder()
    mat = mat_mod.Material.standard(mat_mod.Texture.const_colour((1, 1, 1)),
                                    0)
    if bulk:
        b.add_spheres(g.uniform(-10, 10, (n, 3)), g.uniform(0.1, 0.4, n),
                      mat, colours=g.uniform(0, 1, (n, 3)))
    else:
        for _ in range(n):
            b.add_sphere(g.uniform(-10, 10, 3), float(g.uniform(0.1, 0.4)),
                         mat)
    return b.build(device="cpu") if scene_mod is tscene else b.build()


def _rays(n, seed, spread=12.0):
    g = np.random.default_rng(seed)
    o = (g.normal(size=(3, n)) * spread).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(
        np.float32)


def _both(n, seed, bulk, ray_seed=9):
    js = _spheres(jmat, jscene, n, seed, bulk)
    ts = _spheres(tmat, tscene, n, seed, bulk)
    o, d = _rays(N_RAYS, ray_seed)
    jt, jb = jstats(jnp.asarray(o), jnp.asarray(d), js)
    tt, tb = ic.intersection_stats(torch.from_numpy(o), torch.from_numpy(d),
                                   ts)
    return js, ts, (np.asarray(jt), jb), (tt, tb)


def test_stats_equal_jax_per_ray_index_ordered():
    js, ts, (jt, jb), (tt, tb) = _both(600, 5, bulk=False)
    assert ts.sph_cell_order.shape[0] == 1 and ts.sph_supers.shape[0] > 0
    assert js.sph_lane_leaf == js.tri_lane_leaf == 0
    assert tt.dtype == torch.float32 and tt.shape == (N_RAYS,)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert tb == jb == ts.sph_clusters.shape[0] > 0
    assert 0 < tt.mean() < ts.num_spheres      # culling beats brute force


def test_stats_cell_ordered_scene_within_measured_bound():
    js, ts, (jt, jb), (tt, tb) = _both(1500, 21, bulk=True)
    assert ts.sph_cell_order.shape[0] > 1
    tt = tt.numpy()
    assert tb == jb
    assert (tt == jt).mean() >= 0.9
    assert abs(tt.mean() - jt.mean()) <= 0.03 * jt.mean()


@pytest.mark.parametrize("num", [4, 2, 0])
def test_stats_on_reference_scenes(num):
    """The reference scenes build without lane tables (the lane traversal
    is not ported) and in index order, so the counts equal JAX's per ray.
    Scene 4 gates four sphere clusters; scenes 2 and 0 have a clusterless
    pool, which counts whole (flat_adjust)."""
    kw = {"seed": 0} if num == 4 else {}
    js, _ = rt.build_scene(num, **kw)
    ts, _ = rtt.build_scene(num, **kw, device="cpu")
    assert js.sph_lane_leaf == js.tri_lane_leaf == 0
    assert ts.sph_cell_order.shape[0] == ts.tri_cell_order.shape[0] == 1
    o, d = _rays(N_RAYS, 3, spread=2.0)
    tests, boxes = ic.intersection_stats(torch.from_numpy(o),
                                         torch.from_numpy(d), ts)
    jt, jb = jstats(jnp.asarray(o), jnp.asarray(d), js)
    np.testing.assert_array_equal(tests.numpy(), np.asarray(jt))
    assert boxes == jb == ts.sph_clusters.shape[0] + ts.tri_clusters.shape[0]
    flat = (ts.sph_center.shape[0] if ts.sph_clusters.shape[0] == 0 else 0) \
        + (ts.tri_v0.shape[0] if ts.tri_clusters.shape[0] == 0 else 0)
    assert (tests >= flat).all()
    assert float(tests.mean()) > flat or boxes == 0


def test_plain_counts_follow_the_walk():
    """The plain counter on scene 4 (four sphere clusters, eight triangles
    without clusters): a ray that enters no box counts the triangle pool
    only; a ray aimed at a sphere's centre enters its cluster and counts
    that cluster's spheres as well, and no ray counts more than every
    primitive."""
    ts, _ = rtt.build_scene(4, seed=0, device="cpu")
    ps = tsweep.pack(ts)
    assert ps.n_sph_cl == 4 and ps.n_tri_cl == 0 and ps.n_sph_sup == 0
    flat = float(ps.n_tri)
    cl = ts.sph_clusters
    cam = torch.tensor([0.0, 0.5, -6.0])
    o = torch.stack([torch.tensor([0.0, 100.0, 0.0])]
                    + [cam] * cl.shape[0]).T.contiguous()
    # one sphere per cluster: the first of its leaf
    centres = ts.sph_center[[c * ps.sph_leaf for c in range(cl.shape[0])]]
    d = torch.cat([torch.tensor([[0.0, 1.0, 0.0]]),
                   centres - cam[None, :]])
    d = (d / d.norm(dim=1, keepdim=True)).T.contiguous()
    tests = ic.primitive_tests_reference(ps, o, d)
    assert float(tests[0]) == flat
    for c in range(cl.shape[0]):
        assert float(tests[1 + c]) >= flat + float(cl[c, 7])
    assert (tests <= flat + float(cl[:, 7].sum())).all()


def test_counted_launch_outputs_match_k5():
    """The counting arm's 12 first outputs are K5's; CPU tensors take the
    plain versions and launch nothing."""
    ts, _ = rtt.build_scene(4, seed=0, device="cpu")
    ws = ic.WaveScene(ts)
    o, d = (torch.from_numpy(x) for x in _rays(N_RAYS, 4, spread=2.0))
    before = trace.counts()
    out = ic.hit_resolve_counted(ws.packed, o, d)
    assert len(out) == 13 and out[12].dtype == torch.float32
    plain = ic.hit_resolve_unit(ws, o, d)
    for a, b in zip(out[:12], plain):
        assert torch.equal(a, b)
    assert trace.counts() == before


def test_stats_raise_past_fits_smem():
    """JAX raises for scenes over its SMEM budget (its HBM-streamed kernel
    has no counters); so does the port, for a SceneArrays or a WaveScene."""
    g = np.random.default_rng(1)
    b = tscene.SceneBuilder()
    n = 40000
    b.add_spheres(g.uniform(-50, 50, (n, 3)), np.full(n, 0.1),
                  tmat.Material.standard(
                      tmat.Texture.const_colour((1, 1, 1)), 0))
    ts = b.build(device="cpu")
    assert not ic.fits_smem(ts)
    o, d = (torch.from_numpy(x) for x in _rays(8, 1))
    for scene in (ts, ic.WaveScene(ts)):
        with pytest.raises(ValueError, match="beyond-SMEM"):
            ic.intersection_stats(o, d, scene)


def test_resolve_args_binding_without_nvcc():
    """The ctypes ResolveArgs struct matches RtResolveArgs field by field,
    the stats pointer, the skip arm's sample pointer and the group size
    included, and the counting arm is a template argument of every group
    instance, beside the skip arm's."""
    from raytracer_tpu_torch.kernels import build
    src = (pathlib.Path(ic.__file__).resolve().parents[1] / "csrc" /
           "megakernel.cu").read_text()
    body = re.search(r"struct RtResolveArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [re.sub(r"\[\d+\]", "", d.split()[-1].lstrip("*"))
             for d in body.split(";") if d.strip()]
    assert names == [f[0] for f in build.ResolveArgs._fields_]
    assert names[-2:] == ["n", "group"]
    assert names[-4:-2] == ["sample", "spp"]
    assert "template <int G, bool kStats, bool kMask>" in src
    assert "hit_resolve_kernel<G, true, false>" in src
