"""raytracer_tpu_torch's wavefront hit (ops/intersect_cuda.py) against
raytracer_tpu: the plain K5 and K6 against the Pallas kernels in interpret
mode and the XLA oracle, the blocked layout against what JAX hands its
pallas_call, and the SMEM routing.

The rules are those of ``_assert_oracle_match`` (tests/test_pallas.py:16-36):
hit or miss equal on every ray; t within 1.5e-3; the winner equal where the
two t agree within 3e-4 (a grazing ray can tie two primitives within the
drift of the half-b sphere quadratic); at least 95% of rays decisive. The
plain K5 and K6 test every primitive, the TPU kernels gate tiles of rays and
sweep near-first, so they may differ only on exact ties and grazing rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as rtt
from raytracer_tpu.ops import intersect as jint
from raytracer_tpu.ops import intersect_pallas as jip
from raytracer_tpu.ops import sweep as jsweep
from raytracer_tpu_torch.ops import intersect_cuda as ic
from raytracer_tpu_torch.runtime import loader as tloader
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def same_bvh():
    """Both packages build their BVH natively where g++ builds the host
    library (test_torch_scene.py), so the primitive orders agree."""
    from test_torch_scene import jax_native_loaded
    assert jax_native_loaded() == tloader.native_available()


def _assert_oracle_match(rec_p, rec_x, rtol=3e-4, atol=3e-4):
    """tests/test_pallas.py:16-36 on a port record against a JAX one."""
    hit = np.asarray(rec_x.hit)
    np.testing.assert_array_equal(rec_p.hit.numpy(), hit)
    tp, tx = rec_p.t.numpy()[hit], np.asarray(rec_x.t)[hit]
    np.testing.assert_allclose(tp, tx, rtol=rtol, atol=max(atol, 1.5e-3))
    decisive = np.abs(tp - tx) <= atol + rtol * np.abs(tx)
    np.testing.assert_array_equal(rec_p.idx.numpy()[hit][decisive],
                                  np.asarray(rec_x.idx)[hit][decisive])
    np.testing.assert_array_equal(rec_p.is_tri.numpy()[hit][decisive],
                                  np.asarray(rec_x.is_tri)[hit][decisive])
    assert decisive.mean() > 0.95
    return hit


def _rays(n, seed, spread):
    g = np.random.default_rng(seed)
    o = (g.normal(size=(3, n)) * spread).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=0, keepdims=True)


def _box_rays(scene, n, seed):
    """Origins uniform in the box of the scene's sphere centres and
    triangle corners, directions uniform on the sphere."""
    pts = np.concatenate([scene.sph_center.numpy(), scene.tri_v0.numpy()])
    g = np.random.default_rng(seed)
    o = g.uniform(pts.min(axis=0), pts.max(axis=0), (n, 3)).T
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _field(pkg, n_sph, seed, n_tri=0):
    """Random spheres (and triangles) built the same way in both packages
    (the scenes of tests/test_pallas.py)."""
    from importlib import import_module
    mats = import_module(pkg.__name__ + ".models.materials")
    M, T = mats.Material, mats.Texture
    b = import_module(pkg.__name__ + ".models.scene").SceneBuilder()
    g = np.random.default_rng(seed)
    if n_sph:
        b.add_spheres(g.uniform(-10, 10, (n_sph, 3)),
                      g.uniform(0.1, 0.4, n_sph),
                      M.standard(T.const_colour((1, 1, 1)), 0.3),
                      colours=g.uniform(0, 1, (n_sph, 3)))
    white = M.standard(T.const_colour((0.9, 0.9, 0.9)), 0)
    for _ in range(n_tri):
        p = g.uniform(-10, 10, 3)
        b.add_triangle(p, p + g.uniform(-1, 1, 3), p + g.uniform(-1, 1, 3),
                       white)
    return b.build(device="cpu") if pkg is rtt else b.build()


def test_plain_k5_matches_jax_interpret_kernel():
    """One 4096-ray tile over scene 2 (textured sphere and checker
    triangle): the JAX K5 in interpret mode and the plain K5 with the
    shared resolve."""
    js, _ = rt.build_scene(2)
    ts, _ = rtt.build_scene(2, device="cpu")
    o, d = _box_rays(ts, jip.RAY_TILE, 3)
    rec_j, sh_j = jip.hit_and_resolve_pallas(jnp.asarray(o), jnp.asarray(d),
                                             js, need_sphere_uv=True)
    ws = ic.WaveScene(ts)
    assert not ws.blocked
    rec_t, sh_t = ic.hit_and_resolve(ws, torch.from_numpy(o),
                                     torch.from_numpy(d))
    hit = _assert_oracle_match(rec_t, rec_j)
    assert hit.mean() > 0.4 and sh_t.u.numpy()[hit].any()
    for f, tol in (("point", 1e-3), ("normal", 1e-3), ("u", 1e-3),
                   ("v", 1e-3)):
        np.testing.assert_allclose(getattr(sh_t, f).numpy()[..., hit],
                                   np.asarray(getattr(sh_j, f))[..., hit],
                                   rtol=0, atol=tol, err_msg=f)
    for f in ("mat_id", "colour", "smooth"):
        np.testing.assert_array_equal(getattr(sh_t, f).numpy()[..., hit],
                                      np.asarray(getattr(sh_j, f))[..., hit])


@pytest.mark.parametrize("case", ["scene1", "scene4", "supers600",
                                  "cells1500"])
def test_plain_k5_matches_xla_oracle(case):
    """Scenes 1 and 4, the 600-sphere scene with super clusters and the
    1500-sphere scene with cell orders (tests/test_pallas.py:47-161)."""
    if case == "scene1":
        js, ts = rt.build_scene(1)[0], rtt.build_scene(1, device="cpu")[0]
        o, d = _rays(jip.RAY_TILE + 100, 0, 0.2)
    elif case == "scene4":
        js = rt.build_scene(4, seed=0)[0]
        ts = rtt.build_scene(4, seed=0, device="cpu")[0]
        o, d = _rays(2048, 1, 3.0)
    elif case == "supers600":
        js, ts = (_field(p, 600, 11) for p in (rt, rtt))
        assert ts.sph_supers.shape[0] > 0
        o, d = _rays(512, 12, 12.0)
    else:
        js, ts = (_field(p, 1500, 21) for p in (rt, rtt))
        assert ts.sph_cell_order.shape[0] > 1
        o, d = _rays(512, 22, 12.0)
    rec_x = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), js,
                             backend="xla")
    ws = ic.WaveScene(ts)
    assert not ws.blocked
    rec_t = ic.nearest_hit(ws, torch.from_numpy(o), torch.from_numpy(d))
    hit = _assert_oracle_match(rec_t, rec_x)
    assert hit.any()


def _capture_blocked(js, o, d, run_kernel):
    """The inputs JAX hands the blocked kernel's pallas_call, with the
    layout8 / block_layout reshapes undone, and the call's result (None
    when ``run_kernel`` is False: the call then returns zeros)."""
    got = {}
    real = jip.pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            got["args"] = [np.asarray(a) for a in args]
            if run_kernel:
                return call(*args)
            return tuple(jnp.zeros(s.shape, s.dtype)
                         for s in kw["out_shape"])
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jip.pl, "pallas_call", spy)
    mp.setattr(jip, "_FORCE_BLOCKED", True)
    try:
        out = jip.hit_and_resolve_pallas(jnp.asarray(o), jnp.asarray(d), js)
    finally:
        mp.undo()
    return got["args"], (out if run_kernel else None)


def _unlayout8(x, rows):
    cc = x.shape[0] // 8
    return x.reshape(8, cc, 128).transpose(1, 2, 0).reshape(cc * 128, 8)[:rows]


def _unblock(x, words, block, nblocks):
    return x.reshape(nblocks, words, block // 128, 128).transpose(
        1, 0, 2, 3).reshape(words, nblocks * block)


@pytest.mark.parametrize("n_sph,n_tri", [(700, 40), (4500, 40), (0, 1300)])
def test_blocked_tables_equal_jax(n_sph, n_tri):
    """Every table of the blocked layout array-equal to the JAX kernel's
    inputs: one block, two sphere blocks with a filler triangle block, and
    a triangle-only scene whose sphere pool is all filler."""
    js, ts = (_field(p, n_sph, 31 if n_sph else 17, n_tri)
              for p in (rt, rtt))
    o, d = _rays(256, 32, 12.0)
    args, _ = _capture_blocked(js, o, d, run_kernel=False)
    bt = ic.blocked_tables(ts)
    nb = bt.nblocks
    pairs = {
        "sph_cl": (bt.sph_cl, _unlayout8(args[0], bt.sph_cl.shape[0])),
        "tri_cl": (bt.tri_cl, _unlayout8(args[1], bt.tri_cl.shape[0])),
        "sph_sup": (bt.sph_sup, _unlayout8(args[2], bt.sph_sup.shape[0])),
        "tri_sup": (bt.tri_sup, _unlayout8(args[3], bt.tri_sup.shape[0])),
        "bbox": (bt.bbox, _unlayout8(args[4], bt.bbox.shape[0])),
        "sphf": (bt.sphf, _unblock(args[7], 4, ic.SPH_BLOCK, nb)),
        "sphi": (bt.sphi, _unblock(args[8], 2, ic.SPH_BLOCK, nb)),
        "trif": (bt.trif, _unblock(args[9], 24, ic.TRI_BLOCK, nb)),
        "trii": (bt.trii, _unblock(args[10], 2, ic.TRI_BLOCK, nb)),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (bt.sph_blocks, bt.tri_blocks) == {
        (700, 40): (1, 1), (4500, 40): (2, 1), (0, 1300): (1, 2)}[
            (n_sph, n_tri)]
    assert np.isnan(bt.bbox.numpy()).any() == (n_sph != 700)


def test_plain_k6_matches_jax_blocked_kernel():
    """The 700-sphere + 40-triangle scene forced onto the blocked kernel
    (tests/test_pallas.py:164-195): plain K6 against JAX's interpret
    kernel, and both against the XLA oracle."""
    js, ts = (_field(p, 700, 31, 40) for p in (rt, rtt))
    o, d = _rays(512, 32, 12.0)
    _, (rec_j, sh_j) = _capture_blocked(js, o, d, run_kernel=True)
    ws = ic.WaveScene(ts, blocked=True)
    rec_t, sh_t = ic.hit_and_resolve(ws, torch.from_numpy(o),
                                     torch.from_numpy(d))
    hit = _assert_oracle_match(rec_t, rec_j)
    rec_x = jint.nearest_hit(jnp.asarray(o), jnp.asarray(d), js,
                             backend="xla")
    _assert_oracle_match(rec_t, rec_x)
    np.testing.assert_array_equal(sh_t.mat_id.numpy()[hit],
                                  np.asarray(sh_j.mat_id)[hit])
    np.testing.assert_array_equal(sh_t.colour.numpy()[:, hit],
                                  np.asarray(sh_j.colour)[:, hit])
    # the resident route on the same scene gives the same winners
    rec_r = ic.nearest_hit(ic.WaveScene(ts, blocked=False),
                           torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(rec_r.idx, rec_t.idx)
    assert torch.equal(rec_r.t, rec_t.t)


def _bench_pairs():
    from raytracer_tpu.models import bench_scenes as jb
    from raytracer_tpu.models.scenes import procedural_earth_texture as je
    from raytracer_tpu_torch.models import bench_scenes as tb
    from raytracer_tpu_torch.models.scenes import (
        procedural_earth_texture as te)
    for num in range(5):
        kw = {"seed": 0} if num == 4 else {}
        yield f"scene{num}", rt.build_scene(num, **kw)[0], \
            rtt.build_scene(num, **kw, device="cpu")[0]
    for name, fn, kw in (
            ("rtiow_trio", "rtiow_trio_scene", {}),
            ("cube", "cube_scene", {}),
            ("monkey", "monkey_light_scene", {}),
            ("stress10k", "stress_10k_scene", {}),
            ("stress100k", "stress_10k_scene", {"num": 100000, "seed": 1})):
        yield name, getattr(jb, fn)(**kw)[0], \
            getattr(tb, fn)(**kw, device="cpu")[0]
    yield "earth2048", rt.build_scene(2, earth_image=je(1024))[0], \
        rtt.build_scene(2, earth_image=te(1024), device="cpu")[0]


def test_smem_bytes_and_routing_equal_jax():
    """``smem_bytes`` gives the JAX number on scenes 0-4 and the bench
    scenes, so the port sends the same scenes to K6."""
    routed = {}
    for name, js, ts in _bench_pairs():
        assert ic.smem_bytes(ts) == jsweep.smem_bytes(js), name
        assert ic.fits_smem(ts) == jsweep.fits_smem(js), name
        routed[name] = ic.WaveScene(ts).blocked
    assert [k for k, v in routed.items() if v] == ["stress100k"]


def test_wrappers_check_inputs_and_count_nothing_on_cpu():
    ts, _ = rtt.build_scene(4, seed=0, device="cpu")
    ws = ic.WaveScene(ts)
    o, d = (torch.from_numpy(a) for a in _rays(300, 5, 2.0))
    before = trace.counts()
    rec, shade = ic.hit_and_resolve(ws, o, d)
    assert trace.counts() == before
    assert rec.t.shape == (300,) and shade.normal.shape == (3, 300)
    assert shade.mat_id.dtype == torch.int32
    # scaled directions: t comes back in the caller's parameterisation
    rec2 = ic.nearest_hit(ws, o, d * 2.0)
    torch.testing.assert_close(rec2.t[rec.hit] * 2.0, rec.t[rec.hit])
    for bad in ((o.T, d.T), (o.double(), d.double()), (o, d[:, :10]),
                (o.to("meta"), d.to("meta"))):
        with pytest.raises(ValueError):
            ic.nearest_hit(ws, *bad)
    # scene 4's sphere leaves (28) do not tile a 4096-sphere block
    with pytest.raises(ValueError, match="leaf size"):
        ic.WaveScene(ts, blocked=True)


def test_wavefront_kernel_sources_and_binding_without_nvcc(tmp_path,
                                                           monkeypatch):
    """The new entry points exist, their ctypes argument structs match the
    C structs field by field (K5 and K6 end with the group size), K6 has
    no shared memory and no CTA barrier, and every header a source
    includes is part of the library's hash (a changed header rebuilds the
    library)."""
    import re
    import shutil

    from test_torch_megakernel import CSRC, _c_struct_fields

    from raytracer_tpu_torch.kernels import build
    srcs = {name: (CSRC / name).read_text() for name in build.SOURCES}
    assert "wavefront.cu" in srcs
    for name, entry in (("megakernel.cu", "rt_hit_resolve"),
                        ("wavefront.cu", "rt_hit_resolve_blocked")):
        assert re.search(r"\bint %s\(" % entry, srcs[name])
    for name, c_name, py in (("megakernel.cu", "RtResolveArgs",
                              build.ResolveArgs),
                             ("wavefront.cu", "RtBlockedArgs",
                              build.BlockedArgs)):
        assert _c_struct_fields(srcs[name], c_name) == [
            f[0] for f in py._fields_]
    for py in (build.ResolveArgs, build.BlockedArgs):
        assert [f[0] for f in py._fields_][-2:] == ["n", "group"]
    for word in ("__shared__", "__syncthreads", "cudaFuncSetAttribute"):
        assert word not in srcs["wavefront.cu"]
    assert "template <int G>" in srcs["wavefront.cu"]
    included = {h for src in srcs.values()
                for h in re.findall(r'#include "([^"]+)"', src)}
    assert included
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    before = build.library_path()
    assert before == build.library_path()
    for h in sorted(included):
        with open(copy / h, "a") as f:
            f.write("// edited\n")
        after = build.library_path()
        assert after != before, f"{h} is not part of the library's hash"
        before = after
