"""The nearest-hit tie order and the group rule of raytracer_tpu_torch.

The CUDA walk (K2) runs G threads a ray, strides each leaf's primitives
over them and merges the candidates on the key (t, is_triangle, primitive
index), so its winner is the plain version's at every G. These tests hold
that key
on the plain versions against raytracer_tpu's wavefront oracle,
``ops/intersect.nearest_hit`` (argmin within a pool, the first index on a
tie; ``is_tri = tri_t < sph_t``, intersect.py:298), on a scene of exact
ties (tests/test_torch_tie_scene.py): a sphere and a triangle at the same
t, and two identical spheres in different clusters. The card tests
(test_torch_cuda.py) hold the kernel to the same winners at every G.

The wavefront kernel K6 visits its blocked layout in the order (block,
spheres before triangles, index in the block), and its plain version
merges the block winners in that order; on the blocked variant of the tie
scene that order picks a block-0 triangle over a block-1 sphere at the same
t, where the order above (and JAX's oracle) picks the sphere.

Then the rules that pick G (``sweep.group_size`` with the megakernel's
``MEGA_WAVES``, rt_nearest_hit's ``NEAREST_WAVES`` and the wavefront
kernels' ``RESOLVE_WAVES`` and ``BLOCKED_WAVES``) as plain functions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tie_scene as tie_scene
from raytracer_tpu.models import scene as jscene
from raytracer_tpu.models.materials import Material as JMaterial
from raytracer_tpu.ops import intersect as jint
from raytracer_tpu_torch.models import scene as tscene
from raytracer_tpu_torch.models.materials import Material as TMaterial
from raytracer_tpu_torch.ops import intersect_cuda as tic
from raytracer_tpu_torch.ops import megakernel as tmk
from raytracer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(2)

# Threads an H100 keeps resident for each group arm of rt_megakernel (72
# registers: 7 blocks of 128 threads on each of 132 SMs) and of
# rt_nearest_hit (48 warps an SM at G = 1, 36 above)
MEGA_RESIDENT = {g: 132 * 7 * 128 for g in tsweep.GROUPS}
NEAREST_RESIDENT = {g: 132 * (48 if g == 1 else 36) * 32
                    for g in tsweep.GROUPS}
# ... and of K5 (rt_hit_resolve: as rt_nearest_hit) and K6
# (rt_hit_resolve_blocked: 40 warps an SM at G = 1, 32 above)
RESOLVE_RESIDENT = NEAREST_RESIDENT
BLOCKED_RESIDENT = {g: 132 * (40 if g == 1 else 32) * 32
                    for g in tsweep.GROUPS}
SLOTS_1000x800_PP8 = 25 * 4096      # ceil(800,000 / 32,768) tiles
SLOTS_1000x800_PP1 = 196 * 4096     # ceil(800,000 / 4,096) tiles
SLOTS_4K_1SPP_PP8 = 254 * 4096      # ceil(8,294,400 / 32,768) tiles
SLOTS_256x128_PP8 = 4096            # one tile
SLOTS_256x128_PP1 = 8 * 4096


@pytest.fixture(scope="module")
def scenes(same_bvh):
    """The tie scene in both packages, A duplicated into B."""
    js = tie_scene.build(jscene.SceneBuilder(), JMaterial.default())
    ts = tie_scene.build(tscene.SceneBuilder(), TMaterial.default())
    c, r, cl, ab = tie_scene.duplicate_a(
        ts.sph_center.numpy(), ts.sph_radius.numpy(),
        ts.sph_clusters.numpy(), int(ts.sph_leaf))
    ts = dataclasses.replace(ts, sph_center=torch.as_tensor(c),
                             sph_radius=torch.as_tensor(r),
                             sph_clusters=torch.as_tensor(cl))
    js = dataclasses.replace(js, sph_center=jnp.asarray(c),
                             sph_radius=jnp.asarray(r),
                             sph_clusters=jnp.asarray(cl))
    return js, ts, ab


@pytest.fixture(scope="module")
def same_bvh():
    from test_torch_scene import jax_native_loaded
    from raytracer_tpu_torch.runtime import loader as tloader
    assert jax_native_loaded() == tloader.native_available()


def _expected(ts, ab):
    """Winner codes of the tie rays: P (not the triangle) on the first
    N_AXIS rays, min(A, B) on the next N_AXIS."""
    p = int(np.flatnonzero((ts.sph_center.numpy() == np.float32(
        tie_scene.P_CENTRE)).all(axis=1))[0])
    n = tie_scene.N_AXIS
    return np.concatenate([np.full(n, 2 * p), np.full(n, 2 * min(ab))])


@pytest.mark.parametrize("fast_div", [True, False])
def test_plain_tie_order_matches_jax_oracle(scenes, fast_div):
    """Every winner of the plain nearest hit is the oracle's, and on the
    tie rays it is the sphere, then the lower index."""
    js, ts, ab = scenes
    o, d = tie_scene.rays()
    rec = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), js)
    hit = np.asarray(rec.hit)
    want = np.where(hit, np.asarray(rec.idx) * 2 + np.asarray(rec.is_tri), 0)
    got = tsweep.nearest_hit_reference(
        tsweep.pack(ts), torch.from_numpy(o), torch.from_numpy(d),
        fast_div=fast_div)[1].numpy()
    np.testing.assert_array_equal(got, want)
    n = 2 * tie_scene.N_AXIS
    np.testing.assert_array_equal(got[:n], _expected(ts, ab))
    aimed = got[n:] >> 1
    assert min(ab) in aimed and max(ab) not in aimed


def test_plain_k6_tie_order_is_visit_order(same_bvh):
    """On the blocked variant (two sphere blocks) the plain K6 gives every
    ray the plain K5's winner, which is JAX's oracle's, except on the exact
    ties of a block-0 triangle with a block-1 sphere, where K6's visit
    order picks the triangle: P over T, T_Q over Q, A over its copy B."""
    js = tie_scene.blocked_variant(
        tie_scene.build_blocked(jscene.SceneBuilder(), JMaterial.default()),
        jnp.asarray)
    ts = tie_scene.blocked_variant(
        tie_scene.build_blocked(tscene.SceneBuilder(), TMaterial.default()),
        torch.as_tensor)
    o, d = tie_scene.blocked_rays()
    rec = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), js)
    hit = np.asarray(rec.hit)
    oracle = np.where(hit, np.asarray(rec.idx) * 2 + np.asarray(rec.is_tri),
                      0)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    k5 = tic.hit_resolve_reference(tsweep.pack(ts), ot, dt)[1].numpy()
    np.testing.assert_array_equal(k5, oracle)
    ws = tic.WaveScene(ts, blocked=True)
    k6 = tic.hit_resolve_unit(ws, ot, dt)[1].numpy()   # the plain K6 on CPU
    n = tie_scene.N_AXIS
    np.testing.assert_array_equal(k6[:3 * n], tie_scene.blocked_axis_codes(ts))
    q_rays = slice(n, 2 * n)
    np.testing.assert_array_equal(
        k5[q_rays], 2 * tie_scene.BLOCKED_SLOTS["q"])   # the sphere Q
    k6[q_rays] = k5[q_rays]
    np.testing.assert_array_equal(k6, k5)
    b = 2 * tie_scene.BLOCKED_SLOTS["b"]
    assert not (k6 == b).any() and (k6 == 2 * tie_scene.BLOCKED_SLOTS[
        "a"]).sum() > 2 * n


def test_nearest_hit_rejects_unknown_group():
    ts = tie_scene.build(tscene.SceneBuilder(), TMaterial.default())
    o, d = (torch.from_numpy(x) for x in tie_scene.rays())
    ps = tsweep.pack(ts)
    for g in (0, 3, 16, -1):
        with pytest.raises(ValueError):
            tsweep.nearest_hit(ps, o, d, _group=g)
    want = tsweep.nearest_hit_reference(ps, o, d)
    for g in (None,) + tsweep.GROUPS:   # the CPU takes the plain version
        got = tsweep.nearest_hit(ps, o, d, _group=g)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("slots, depth, want", [
    (SLOTS_1000x800_PP8, 1, 2),     # scene 4: clusters
    (SLOTS_1000x800_PP8, 0, 1),     # scene 2: flat pools
    (SLOTS_1000x800_PP8, 2, 8),     # stress10k: supers
    (SLOTS_4K_1SPP_PP8, 1, 1),      # the 4K fly-through
    (SLOTS_4K_1SPP_PP8, 2, 4),
    (SLOTS_1000x800_PP1, 2, 8),     # stress10k and stress100k, pixpack 1
    (SLOTS_1000x800_PP1, 1, 1),
    (SLOTS_256x128_PP8, 0, 8),      # small frames: scene 2, scene 4
    (SLOTS_256x128_PP8, 1, 8),
    (SLOTS_256x128_PP1, 0, 2),
    (SLOTS_256x128_PP1, 1, 4),
    (0, 0, 8),
    (1, 0, 8),
    (10 ** 9, 2, 1),
])
def test_group_rule(slots, depth, want):
    """rt_megakernel's rule on the H100's resident threads picks the G
    that was fastest in the measured sweep: the 1000x800 pixpack-8 frame
    (102,400 lane slots) takes G = 2 over clusters, 1 over flat pools and
    8 over supers; the 4K 1 spp frame (1,040,384) takes 1 over clusters;
    one 256x128 tile takes 8 even over flat pools."""
    waves = tmk.MEGA_WAVES[depth]
    g = tsweep.group_size(slots, MEGA_RESIDENT, waves)
    assert g == want
    assert g == 1 or slots * g <= waves * MEGA_RESIDENT[g]


@pytest.mark.parametrize("rays, depth, want", [
    (1 << 20, 0, 1),                # scene 2
    (1 << 20, 1, 1),                # scene 4
    (1 << 20, 2, 8),                # stress10k
    (1 << 16, 0, 2),
    (1 << 16, 1, 8),
    (1 << 16, 2, 8),
])
def test_nearest_rule(rays, depth, want):
    """rt_nearest_hit's rule: one thread a ray at 1M rays over clusters or
    flat pools, G = 8 over supers (2.7x G = 1 on stress10k)."""
    waves = tsweep.NEAREST_WAVES[depth]
    assert tsweep.group_size(rays, NEAREST_RESIDENT, waves) == want


@pytest.mark.parametrize("rays, depth, want", [
    (1 << 20, 0, 1),                # scene 2
    (1 << 20, 1, 1),                # scene 4
    (1 << 20, 2, 8),                # stress100k over the resident pools
    (1 << 16, 0, 2),
    (1 << 16, 1, 8),
    (1 << 16, 2, 8),
])
def test_resolve_rule(rays, depth, want):
    """K5's rule (rt_hit_resolve), by the scene's gate depth."""
    waves = tic.RESOLVE_WAVES[depth]
    assert tsweep.group_size(rays, RESOLVE_RESIDENT, waves) == want


@pytest.mark.parametrize("rays, want", [
    (1 << 20, 8),                   # phase 10's field rays over stress100k
    (800_000, 8),                   # a stress100k regen bounce at 1000x800
    (1 << 16, 8),
    (4096, 8),
])
def test_blocked_rule(rays, want):
    """K6's rule (rt_hit_resolve_blocked): the blocked layout always gates
    by block unions, supers and clusters."""
    assert tsweep.group_size(rays, BLOCKED_RESIDENT,
                             tic.BLOCKED_WAVES) == want


def test_wavefront_rules_take_a_forced_group_and_check_it():
    """``_group`` reaches the rules unchanged, through check_group."""
    scene = tie_scene.build(tscene.SceneBuilder(), TMaterial.default())
    ps = tsweep.pack(scene)
    for g in tsweep.GROUPS:
        assert tic.resolve_group(10, ps, g) == g
        assert tic.blocked_group(10, g) == g
    for g in (0, 3, 16):
        with pytest.raises(ValueError):
            tic.resolve_group(10, ps, g)
        with pytest.raises(ValueError):
            tic.blocked_group(10, g)
    o, d = (torch.from_numpy(x) for x in tie_scene.rays())
    with pytest.raises(ValueError):
        tic.hit_resolve_unit(tic.WaveScene(scene), o, d, _group=3)
    with pytest.raises(ValueError):
        tic.hit_resolve_counted(ps, o, d, _group=5)


def test_group_rule_reads_each_arms_residency():
    """An arm that keeps fewer threads resident is passed over."""
    resident = {1: 4000, 2: 4000, 4: 4000, 8: 100}
    assert tsweep.group_size(1000, resident, 1) == 4
    assert tsweep.group_size(1000, {g: 10 for g in tsweep.GROUPS}, 8) == 1


def test_gate_depth():
    """Scene 2 sweeps its pools whole, scene 4 has clusters, a field of
    1000 spheres has supers."""
    from raytracer_tpu_torch.models import bench_scenes
    import raytracer_tpu_torch as rtt
    assert tsweep.gate_depth(tsweep.pack(rtt.build_scene(2)[0])) == 0
    assert tsweep.gate_depth(tsweep.pack(rtt.build_scene(4, seed=0)[0])) == 1
    field, _ = bench_scenes.stress_10k_scene(num=1000, seed=1)
    assert tsweep.gate_depth(tsweep.pack(field)) == 2


def test_supers_cover_clusters_in_order():
    """The index-order walk meets a pool's primitives in index order, so a
    thread keeps the first of a tie with a strict '<': every super covers
    the next run of clusters, and holds at most 8 of them."""
    from raytracer_tpu_torch.models import bench_scenes
    field, _ = bench_scenes.stress_10k_scene(num=3000, seed=2)
    for sup in (field.sph_supers.numpy(),):
        first, count = sup[:, 6], sup[:, 7]
        assert first[0] == 0 and (count >= 1).all() and (count <= 8).all()
        np.testing.assert_array_equal(first[1:], first[:-1] + count[:-1])
        assert first[-1] + count[-1] == field.sph_clusters.shape[0]


def test_check_group():
    for g in (None, 1, 2, 4, 8):
        tsweep.check_group(g)
    for g in (0, 3, 5, 16, -2):
        with pytest.raises(ValueError):
            tsweep.check_group(g)
