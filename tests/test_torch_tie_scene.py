"""An exact-tie scene for the nearest-hit order, in plain numpy so that the
JAX and the torch tests (and the card tests, which import no jax) build
the same scene with their own SceneBuilder; and the check that its ties
are exact in the plain version's math.

The scene: 100 small random spheres above the plane y = 5, a sphere P of
radius 1 at (0, 0, 5) that touches the triangle T in the plane z = 4 at
(0, 0, 4), and a sphere A of radius 1 at (3, 0, 5). ``duplicate_a`` then
copies A over the first sphere slot of another cluster (B) and grows that
cluster's box to hold it: two identical spheres in different clusters.

The rays: along +z through (0, 0) (P and T tie at t = 4 + k, exactly),
along +z through (3, 0) (A and B tie), and rays from all around aimed at
A (A and B tie; the two clusters are entered in either order). Every tie
has one winner in the order (t, is_triangle, primitive index): the sphere
over the triangle, the lower index of A and B.

The blocked variant (``build_blocked``, ``into_blocks``) is the same
scene over 4,500 random spheres, so that the blocked layout of the
wavefront kernel K6 holds two 4096-sphere blocks, with a third sphere Q at
(-3, 0, 5) touching a second triangle T_Q in the plane z = 4. P and A go
into sphere block 0, Q and B into block 1. There a tie has one winner in
K6's visit order (block, spheres before triangles, index in the block):
P over T, A over B, and T_Q (triangle block 0) over Q (sphere block 1),
where the order (t, is_triangle, index) would pick Q.
"""

import dataclasses

import numpy as np
import torch

P_CENTRE = (0.0, 0.0, 5.0)
A_CENTRE = (3.0, 0.0, 5.0)
TRIANGLE = ((-0.5, -0.5, 4.0), (1.5, -0.5, 4.0), (-0.5, 1.5, 4.0))
N_AXIS = 16      # axis rays per tie, from z = 0, -1, ..., -15
N_AIMED = 4096
# the blocked variant
Q_CENTRE = (-3.0, 0.0, 5.0)
TRIANGLE_Q = ((-3.5, -0.5, 4.0), (-1.5, -0.5, 4.0), (-3.5, 1.5, 4.0))
N_FIELD_BLOCKED = 4500
SPH_BLOCK = 4096
# where into_blocks puts P, A, Q and B (the copy of A)
BLOCKED_SLOTS = {"p": 10, "a": 20, "q": SPH_BLOCK + 10, "b": SPH_BLOCK + 20}


def build(builder, material) -> object:
    """The scene through a SceneBuilder instance and a default material
    (either package's), before ``duplicate_a``."""
    g = np.random.default_rng(21)
    n = 100
    centres = np.column_stack([g.uniform(-20, 20, n), g.uniform(6, 20, n),
                               g.uniform(0, 40, n)])
    builder.add_spheres(centres, g.uniform(0.2, 0.5, n), material)
    builder.add_sphere(P_CENTRE, 1.0, material)
    builder.add_sphere(A_CENTRE, 1.0, material)
    builder.add_triangle(*TRIANGLE, material)
    return builder.build()


def build_blocked(builder, material) -> object:
    """The blocked variant through a SceneBuilder instance and a default
    material, before ``into_blocks``."""
    g = np.random.default_rng(23)
    n = N_FIELD_BLOCKED
    centres = np.column_stack([g.uniform(-20, 20, n), g.uniform(6, 20, n),
                               g.uniform(0, 40, n)])
    builder.add_spheres(centres, g.uniform(0.2, 0.5, n), material)
    for c in (P_CENTRE, A_CENTRE, Q_CENTRE):
        builder.add_sphere(c, 1.0, material)
    builder.add_triangle(*TRIANGLE, material)
    builder.add_triangle(*TRIANGLE_Q, material)
    return builder.build()


def _slot(centre: np.ndarray, c) -> int:
    return int(np.flatnonzero((centre == np.float32(c)).all(axis=1))[0])


def _grow(clusters: np.ndarray, cl: int, c: np.ndarray, r) -> None:
    pad = np.float32(1e-3)
    clusters[cl, :3] = np.minimum(clusters[cl, :3], c - r - pad)
    clusters[cl, 3:6] = np.maximum(clusters[cl, 3:6], c + r + pad)


def into_blocks(centre: np.ndarray, radius: np.ndarray,
                clusters: np.ndarray, leaf: int):
    """Move P, A and Q of the blocked variant to their BLOCKED_SLOTS and
    copy A to B's, growing each target cluster's box around it; the slots
    they leave get radius 0 (never hit). Takes and returns numpy copies of
    sph_center, sph_radius and sph_clusters."""
    centre, radius, clusters = centre.copy(), radius.copy(), clusters.copy()
    src = {k: _slot(centre, c) for k, c in
           (("p", P_CENTRE), ("a", A_CENTRE), ("q", Q_CENTRE))}
    src["b"] = src["a"]
    moved = {k: (centre[v].copy(), radius[v]) for k, v in src.items()}
    radius[list(src.values())] = 0.0
    for k, dst in BLOCKED_SLOTS.items():
        centre[dst], radius[dst] = moved[k]
        _grow(clusters, dst // leaf, *moved[k])
    return centre, radius, clusters


def duplicate_a(centre: np.ndarray, radius: np.ndarray,
                clusters: np.ndarray, leaf: int):
    """Copy sphere A over the first slot of the next cluster (B) and grow
    that cluster's box around it. Takes and returns numpy copies of the
    scene's sph_center (S, 3), sph_radius (S,) and sph_clusters (C, 8);
    also returns (a, b), the two slots."""
    centre, radius, clusters = centre.copy(), radius.copy(), clusters.copy()
    a, p = _slot(centre, A_CENTRE), _slot(centre, P_CENTRE)
    assert clusters.shape[0] > 1, "the sphere pool must be clustered"
    cb = (a // leaf + 1) % clusters.shape[0]
    b = int(clusters[cb, 6])
    b = b + 1 if b == p else b
    centre[b], radius[b] = centre[a], radius[a]
    _grow(clusters, cb, centre[a], radius[a])
    return centre, radius, clusters, (a, b)


def blocked_variant(scene, as_array):
    """``into_blocks`` applied to a built blocked variant of either package
    (``as_array``: torch.as_tensor or jnp.asarray)."""
    c, r, cl = into_blocks(np.asarray(scene.sph_center),
                           np.asarray(scene.sph_radius),
                           np.asarray(scene.sph_clusters),
                           int(scene.sph_leaf))
    return dataclasses.replace(scene, sph_center=as_array(c),
                               sph_radius=as_array(r),
                               sph_clusters=as_array(cl))


def blocked_rays():
    """The blocked variant's rays: the axis rays through P, Q and A, then
    the rays aimed at A."""
    return rays((P_CENTRE, Q_CENTRE, A_CENTRE))


def blocked_axis_codes(scene) -> np.ndarray:
    """K6's winner codes on the axis rays of ``blocked_rays`` over
    ``blocked_variant``: P, then T_Q, then A (block-global codes)."""
    tq = _slot(np.asarray(scene.tri_v0), TRIANGLE_Q[0])
    n = N_AXIS
    return np.concatenate([np.full(n, 2 * BLOCKED_SLOTS["p"]),
                           np.full(n, 2 * tq + 1),
                           np.full(n, 2 * BLOCKED_SLOTS["a"])])


def rays(centres=(P_CENTRE, A_CENTRE)):
    """(o, d) float32 (3, N) unit rays: N_AXIS axis rays along +z through
    each of ``centres`` (P and T, then A, by default; the blocked variant
    adds Q and T_Q), then N_AIMED rays aimed at A."""
    k = np.arange(N_AXIS, dtype=np.float32)
    axes = [np.stack([np.full_like(k, c[0]), np.full_like(k, c[1]), -k])
            for c in centres]
    g = np.random.default_rng(22)
    u = g.standard_normal((3, N_AIMED))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    a = np.asarray(A_CENTRE)[:, None]
    o_aim = a + 6.0 * u
    target = a + g.uniform(-0.7, 0.7, (3, N_AIMED))
    d_aim = target - o_aim
    d_aim /= np.linalg.norm(d_aim, axis=0, keepdims=True)
    axis_d = np.tile(np.array([[0.0], [0.0], [1.0]]),
                     (1, len(centres) * N_AXIS))
    o = np.concatenate(axes + [o_aim], axis=1).astype(np.float32)
    d = np.concatenate([axis_d, d_aim], axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def test_tie_scene_has_exact_ties():
    """The axis rays tie exactly: P's t equals the triangle's (both
    reciprocals), and A's equals B's, in the plain version's math."""
    from raytracer_tpu_torch.models.materials import Material
    from raytracer_tpu_torch.models.scene import SceneBuilder
    from raytracer_tpu_torch.ops import sweep as tsweep
    ts = build(SceneBuilder(), Material.default())
    c, r, cl, (a, b) = duplicate_a(ts.sph_center.numpy(),
                                   ts.sph_radius.numpy(),
                                   ts.sph_clusters.numpy(), int(ts.sph_leaf))
    ts = dataclasses.replace(ts, sph_center=torch.as_tensor(c),
                             sph_radius=torch.as_tensor(r),
                             sph_clusters=torch.as_tensor(cl))
    ps = tsweep.pack(ts)
    o, d = (torch.from_numpy(x) for x in rays())
    cols = [x[:, None] for x in (*o, *d)]
    st = tsweep.sphere_t(ps.sph_f, *cols)
    n = N_AXIS
    for fast_div in (True, False):
        tt = tsweep.triangle_tuv(ps.tri_f, ps.has_one_way, *cols,
                                 fast_div=fast_div)[0].min(dim=1).values
        assert torch.equal(tt[:n], st[:n].min(dim=1).values)
    assert torch.equal(st[:, a], st[:, b])
    assert bool((st[n:2 * n, a] < tsweep.INF).all())
    assert a // ps.sph_leaf != b // ps.sph_leaf
    aimed = st[2 * n:, a] < tsweep.INF
    assert 0.5 < float(aimed.float().mean()) < 1.0


def test_blocked_tie_scene_has_exact_ties():
    """The blocked variant lays out as two sphere blocks with P and A in
    block 0, Q and B in block 1, and its axis rays tie exactly (exact
    division, K6's): P with T, Q with T_Q, A with B."""
    from raytracer_tpu_torch.models.materials import Material
    from raytracer_tpu_torch.models.scene import SceneBuilder
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import sweep as tsweep
    ts = blocked_variant(build_blocked(SceneBuilder(), Material.default()),
                         torch.as_tensor)
    bt = ic.blocked_tables(ts)
    assert (bt.nblocks, bt.sph_blocks, bt.tri_blocks) == (2, 2, 1)
    slots = BLOCKED_SLOTS
    assert [v // SPH_BLOCK for v in slots.values()] == [0, 0, 1, 1]
    o, d = (torch.from_numpy(x) for x in blocked_rays())
    cols = [x[:, None] for x in (*o, *d)]
    st = tsweep.sphere_t(bt.sphf, *cols)
    tt = tsweep.triangle_tuv(bt.trif, bt.has_one_way, *cols,
                             fast_div=False)[0]
    tq = _slot(ts.tri_v0.numpy(), TRIANGLE_Q[0])
    tp = _slot(ts.tri_v0.numpy(), TRIANGLE[0])
    n = N_AXIS
    for rows, s_slot, t_tie in ((slice(0, n), slots["p"], tt[:, tp]),
                                (slice(n, 2 * n), slots["q"], tt[:, tq]),
                                (slice(2 * n, 3 * n), slots["a"],
                                 st[:, slots["b"]])):
        assert torch.equal(st[rows, s_slot], t_tie[rows])
        assert bool((t_tie[rows] < tsweep.INF).all())
        assert torch.equal(st[rows].min(dim=1).values, t_tie[rows])
