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
"""

import dataclasses

import numpy as np
import torch

P_CENTRE = (0.0, 0.0, 5.0)
A_CENTRE = (3.0, 0.0, 5.0)
TRIANGLE = ((-0.5, -0.5, 4.0), (1.5, -0.5, 4.0), (-0.5, 1.5, 4.0))
N_AXIS = 16      # axis rays per tie, from z = 0, -1, ..., -15
N_AIMED = 4096


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


def duplicate_a(centre: np.ndarray, radius: np.ndarray,
                clusters: np.ndarray, leaf: int):
    """Copy sphere A over the first slot of the next cluster (B) and grow
    that cluster's box around it. Takes and returns numpy copies of the
    scene's sph_center (S, 3), sph_radius (S,) and sph_clusters (C, 8);
    also returns (a, b), the two slots."""
    centre, radius, clusters = centre.copy(), radius.copy(), clusters.copy()

    def slot(c):
        return int(np.flatnonzero((centre == np.float32(c)).all(axis=1))[0])
    a, p = slot(A_CENTRE), slot(P_CENTRE)
    assert clusters.shape[0] > 1, "the sphere pool must be clustered"
    cb = (a // leaf + 1) % clusters.shape[0]
    b = int(clusters[cb, 6])
    b = b + 1 if b == p else b
    centre[b], radius[b] = centre[a], radius[a]
    pad = np.float32(1e-3)
    clusters[cb, :3] = np.minimum(clusters[cb, :3],
                                  centre[a] - radius[a] - pad)
    clusters[cb, 3:6] = np.maximum(clusters[cb, 3:6],
                                   centre[a] + radius[a] + pad)
    return centre, radius, clusters, (a, b)


def rays():
    """(o, d) float32 (3, N) unit rays: the axis rays through P and T, the
    axis rays through A, then N_AIMED rays aimed at A."""
    k = np.arange(N_AXIS, dtype=np.float32)
    axis_p = np.stack([np.zeros_like(k), np.zeros_like(k), -k])
    axis_a = np.stack([np.full_like(k, 3.0), np.zeros_like(k), -k])
    g = np.random.default_rng(22)
    u = g.standard_normal((3, N_AIMED))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    a = np.asarray(A_CENTRE)[:, None]
    o_aim = a + 6.0 * u
    target = a + g.uniform(-0.7, 0.7, (3, N_AIMED))
    d_aim = target - o_aim
    d_aim /= np.linalg.norm(d_aim, axis=0, keepdims=True)
    axis_d = np.tile(np.array([[0.0], [0.0], [1.0]]), (1, 2 * N_AXIS))
    o = np.concatenate([axis_p, axis_a, o_aim], axis=1).astype(np.float32)
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
