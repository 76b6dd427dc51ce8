"""raytracer_tpu_torch's wavefront ray set-up (ops/rays.py, ``rt_wave_rays``)
and the bounce on the hit kernels' raw outputs (ops/bounce.py), on the CPU.

- ``wave_rays_reference`` against a frozen copy of the composition it
  replaced (``rng.lane_randoms_reference`` or the tile draw's rows, then
  ``scatter.antialias_jitter``, then ``intersect_cuda._unit_rays`` with its
  padding to 4096-ray tiles): bitwise, with and without a sample fold,
  russian roulette and antialias, and the segment count; the coherent arm
  keyed by a tile key (the host's, or the words and iteration counter in
  device memory, which it advances) bitwise that composition on
  ``rng.tile_rows``' rows, over a partial last tile and over whole
  1024-lane tiles; against the JAX
  package's draw, jitter and normalisation (ops/rng.py,
  ops/scatter.py:34, intersect_pallas.py:737-741) within
  test_torch_wavefront_ops.py's bounds.
- ``wave_bounce_reference`` on K6's raw outputs (9, colour30 and
  smooth|mat undecoded) against today's resolve and bounce, bitwise, on
  scenes 1-3, the gradient scene and the earth, both arms (K5's:
  test_torch_wave_bounce.py).
- Every sampler, coherent included, and ``trace`` through the graph route
  (``wave_graph.capture`` stubbed to replay its body eagerly, as
  test_torch_wave_bounce.py does) against the composition of before
  (test_torch_wave_bounce.py's ``_todays_*``), bitwise.
- The C structs of rt_wave_rays and rt_wave_bounce against their ctypes
  mirrors; the wrapper's checks.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu.ops import scatter as jscatter
from raytracer_tpu_torch.ops import integrator as tint
from raytracer_tpu_torch.ops import rays as trays
from raytracer_tpu_torch.ops import rng as trng
from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
from raytracer_tpu_torch.ops.scatter import antialias_jitter
from raytracer_tpu_torch.utils import trace
from test_torch_megakernel import CSRC, _c_struct_fields
from test_torch_wave_bounce import (SAMPLER_CASES, _rays, _scene,
                                    _todays_mean, _todays_trace,
                                    _todays_unit_rays,
                                    todays_bounce_vs_reference)
from test_torch_wavefront_ops import MAX_NORMAL_ULPS, _ulps

torch.set_num_threads(2)

N = 5000     # not a whole number of 4096-ray tiles: today's padding shows


def _todays_rays(keys, sample_i, bounce_i, d, antialias, with_rr,
                 drawn=None):
    """The ray set-up as composed before ``rt_wave_rays``."""
    if drawn is None:
        drawn = trng.lane_randoms_reference(keys, sample_i, bounce_i,
                                            with_rr)
    dj = antialias_jitter(drawn[0:3], d) if antialias else d
    n = d.shape[1]
    _, d_u, inv_len = _todays_unit_rays(torch.zeros_like(dj), dj)
    return {"dj": dj, "unit": d_u[:, :n], "inv_len": inv_len[:n],
            "gauss": drawn[3:6], "fresnel": drawn[6],
            "rr": drawn[7] if with_rr else None}


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    idx = torch.from_numpy(g.integers(0, 2 ** 31, N).astype(np.int32))
    keys = trng.per_ray_keys(trng.key(4), idx)
    s = torch.from_numpy(g.integers(0, 30, N).astype(np.int32))
    b = torch.from_numpy(g.integers(0, 6, N).astype(np.int32))
    d = g.standard_normal((3, N)).astype(np.float32) * 3.0
    return keys, s, b, torch.from_numpy(d)


def _same(got: trays.WaveRays, want: dict, done=None):
    """Every output bitwise; with ``done`` (the finished lanes,
    ``sample_i >= spp``) on the live lanes, and a finished lane's ``unit``
    and ``inv_len`` ``PARK_UNIT`` and 1 (its ``dj`` and draws are
    unspecified: the kernel writes neither)."""
    live = slice(None) if done is None else ~done
    for k, x in want.items():
        y = getattr(got, k)
        if x is None:
            assert y is None, k
        else:
            assert y.dtype == x.dtype, k
            assert torch.equal(y[..., live], x[..., live]), k
    if done is not None:
        assert bool(done.any()) and not bool(done.all())
        park = torch.tensor(trays.PARK_UNIT)[:, None]
        assert torch.equal(got.unit[:, done],
                           park.expand(3, int(done.sum())))
        assert torch.equal(got.inv_len[done],
                           torch.ones(int(done.sum())))


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("with_rr", [False, True])
@pytest.mark.parametrize("fold", ["sample", "none", "scan"])
def test_wave_rays_reference_is_todays_composition(fold, with_rr,
                                                   antialias):
    """Per-lane draws with a sample fold (regen), without one (a key that
    holds the sample, one bounce for every lane: scan / ``trace``) and
    with per-lane bounces but no fold; the count of live lanes."""
    keys, s, b, d = _inputs()
    segs = torch.zeros((), dtype=torch.int64)
    if fold == "scan":
        alive = s < 12
        got = trays.wave_rays(d, keys=keys, bounce=3, antialias=antialias,
                              with_rr=with_rr, segs=segs, alive=alive)
        want = _todays_rays(keys, None, torch.full((N,), 3,
                                                   dtype=torch.int32),
                            d, antialias, with_rr)
        count = int(alive.sum())
    else:
        sample = s if fold == "sample" else None
        got = trays.wave_rays(d, keys=keys, sample_i=sample, bounce=b,
                              antialias=antialias, with_rr=with_rr)
        want = _todays_rays(keys, sample, b, d, antialias, with_rr)
        if sample is not None:
            trays.wave_rays(d, keys=keys, sample_i=s, bounce=b,
                            with_rr=with_rr, segs=segs, spp=20)
        count = int((s < 20).sum()) if sample is not None else 0
    _same(got, want)
    assert int(segs) == count
    assert got.dj is d or antialias


@pytest.mark.parametrize("with_rr", [False, True])
def test_wave_rays_reference_on_tile_rows(with_rr):
    """The coherent arm: the tile draw's rows (``rng.tile_rows``, split as
    ``rng.tile_randoms`` splits them) drawn under the tile key, its
    Gaussian, Fresnel and russian-roulette rows out as they are, the
    jitter from its rows; a finished lane (``sample_i >= spp``) gets the
    park walk's direction."""
    _, s, _, d = _inputs(1)
    rows = trng.tile_rows(trng.fold_in(trng.key(2), 5), N, with_rr=with_rr,
                          device="cpu")
    segs = torch.zeros((), dtype=torch.int64)
    got = trays.wave_rays(d, tile_key=trng.fold_in(trng.key(2), 5),
                          sample_i=s, with_rr=with_rr, segs=segs, spp=10)
    _same(got, _todays_rays(None, None, None, d, True, with_rr, drawn=rows),
          done=s >= 10)
    assert int(segs) == int((s < 10).sum())
    split = trng.tile_randoms(trng.fold_in(trng.key(2), 5), N,
                              with_rr=with_rr, device="cpu")
    assert torch.equal(torch.cat([split[0], split[1], split[2][None]]
                                 + ([split[3][None]] if with_rr else [])),
                       rows)


@pytest.mark.parametrize("arm", ["host", "device"])
@pytest.mark.parametrize("n", [N, 4096])
@pytest.mark.parametrize("with_rr", [False, True])
@pytest.mark.parametrize("antialias", [True, False])
def test_wave_rays_tile_key_is_todays_composition(antialias, with_rr, n,
                                                  arm):
    """The coherent arm keyed by the iteration's tile key (``tile_key``,
    or ``key_dev`` / ``iter_dev`` as a replayed graph holds them) is
    bitwise the composition it replaced, ``rng.tile_rows``' rows fed to
    the ray set-up of before, on 5000 lanes (a partial last tile) and on
    4096 (four whole tiles), a finished lane on the park walk; the
    device arm advances the counter by one and leaves the ticket zero."""
    _, s, _, d = _inputs(4)
    s, d = s[:n].contiguous(), d[:, :n].contiguous()
    k = trng.fold_in(trng.key(2), 3)
    rows = trng.tile_rows(trng.fold_in(k, 5), n, with_rr=with_rr,
                          device="cpu")
    if arm == "host":
        kw = dict(tile_key=trng.fold_in(k, 5))
    else:
        key_dev = torch.zeros(2, dtype=torch.int64)
        trng.set_key(key_dev, k)
        kw = dict(key_dev=key_dev,
                  iter_dev=torch.tensor([5, 0], dtype=torch.int64))
    segs = torch.zeros((), dtype=torch.int64)
    got = trays.wave_rays(d, sample_i=s, antialias=antialias,
                          with_rr=with_rr, segs=segs, spp=10, **kw)
    if arm == "device":
        assert kw["iter_dev"].tolist() == [6, 0]
    _same(got, _todays_rays(None, None, None, d, antialias, with_rr,
                            drawn=rows), done=s >= 10)
    assert int(segs) == int((s < 10).sum())


@pytest.mark.parametrize("with_rr", [False, True])
def test_wave_rays_match_jax(with_rr):
    """Against the JAX package's lane draw, antialias jitter and the hit
    kernel's normalisation (intersect_pallas.py:737-741): the uniforms
    bitwise, the normals within MAX_NORMAL_ULPS, the directions within
    test_torch_wavefront_ops.py's jitter bound (1e-6)."""
    keys, s, b, d = _inputs(2)
    jk = jax.random.wrap_key_data(jnp.asarray(
        keys.numpy().T.astype(np.uint32)))
    want = jrng.lane_randoms(jk, jnp.asarray(s.numpy()),
                             jnp.asarray(b.numpy()), with_rr=with_rr)
    jdj = jscatter.antialias_jitter(want[0], jnp.asarray(d.numpy()))
    jinv = jax.lax.rsqrt(jnp.sum(jdj * jdj, axis=0))
    got = trays.wave_rays(d, keys=keys, sample_i=s, bounce=b,
                          with_rr=with_rr)
    np.testing.assert_array_equal(got.fresnel.numpy(), np.asarray(want[2]))
    if with_rr:
        np.testing.assert_array_equal(got.rr.numpy(), np.asarray(want[3]))
    assert _ulps(got.gauss.numpy(), want[1]).max() <= MAX_NORMAL_ULPS
    np.testing.assert_allclose(got.dj.numpy(), np.asarray(jdj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.unit.numpy(),
                               np.asarray(jdj * jinv[None, :]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.inv_len.numpy(), np.asarray(jinv),
                               rtol=1e-6, atol=0)


def test_wave_rays_checks_inputs():
    keys, s, b, d = _inputs(3)
    one_of = "one of keys, tile_key and key_dev"
    with pytest.raises(ValueError, match=one_of):
        trays.wave_rays(d, bounce=b)
    with pytest.raises(ValueError, match=one_of):
        trays.wave_rays(d, keys=keys,
                        key_dev=torch.zeros(2, dtype=torch.int64),
                        iter_dev=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match=one_of):
        trays.wave_rays(d, keys=keys, tile_key=trng.key(1))
    with pytest.raises(ValueError, match=one_of):
        trays.wave_rays(d, key_dev=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"iter_dev must be \(2,\) int64"):
        trays.wave_rays(d, key_dev=torch.zeros(2, dtype=torch.int64),
                        iter_dev=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="on d's device"):
        trays.wave_rays(d, key_dev=torch.zeros(2, dtype=torch.int64),
                        iter_dev=torch.zeros(2, dtype=torch.int64,
                                             device="meta"))
    with pytest.raises(ValueError, match=r"\(3, N\) float32"):
        trays.wave_rays(d.double(), keys=keys, bounce=b)
    before = trace.counts()
    trays.wave_rays(d, keys=keys, bounce=b)
    assert trace.counts() == before     # CPU tensors take the plain version


@pytest.mark.parametrize("arm", ["scan", "regen"])
@pytest.mark.parametrize("num", [1, 2, 3, "gradient", "earth"])
def test_wave_bounce_reference_on_k6_raw(num, arm):
    """``wave_bounce_reference`` on K6's 9 raw outputs (the plain K6 over
    the scene's blocked tables; scene 4's leaf size does not tile a
    block) is today's resolve and bounce."""
    todays_bounce_vs_reference(num, arm, "rr", blocked=True)


# -- the samplers through the graph route against the composition before ----

class _EagerGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def eager_graphs(monkeypatch):
    """The kernel route's CPU tensors through the graph route, captures
    replaced by eager replays (test_torch_wave_bounce.py's fixture)."""
    from raytracer_tpu_torch.ops import wave_graph as twg
    captured = []

    def capture(ws, n, body):
        captured.append((id(ws), n))
        return twg.Graph(_EagerGraph(body), collections.Counter(
            ("rt_wave_rays", "rt_hit_resolve", "rt_wave_bounce")))
    monkeypatch.setattr(tint, "_replays",
                        lambda backend, o: backend == "pallas")
    monkeypatch.setattr(twg, "capture", capture)
    return captured


@pytest.mark.parametrize("sampler,coherent", SAMPLER_CASES)
def test_graph_route_is_todays_composition(eager_graphs, sampler, coherent):
    """Scene 4 at 64x32, 3 spp, 4 bounces, russian roulette from bounce 2,
    antialias, tile offset 2: the graph route's frame (the iteration of
    three kernels, replayed) is bitwise the composition it replaced."""
    scene, sky = _scene(4)
    s = rtt.RenderSettings(rays_per_pixel=3, reflect_limit=4,
                           sampler=sampler, coherent=coherent,
                           russian_roulette=2).with_sky(sky)
    o, d, idx = _rays(4, 64, 32)
    ws = WaveScene(scene)
    fkey = trng.frame_key(trng.key(1), 2)
    got = tint.render_sample_mean(ws, s, o, d, fkey, tile_offset=2,
                                  ray_idx=idx)
    want = _todays_mean(WaveScene(scene), s, o, d, fkey, idx, tile_offset=2)
    assert eager_graphs
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


@pytest.mark.parametrize("num", [2, 4])
def test_graph_trace_is_todays_trace(eager_graphs, num):
    """``trace`` through the graph route (scene 2: sphere UV; scene 4) is
    bitwise the scan sample of before, radiance and segments."""
    scene, sky = _scene(num)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=4,
                           russian_roulette=2).with_sky(sky)
    o, d, idx = _rays(num)
    key = trng.sample_key(trng.frame_key(trng.key(3), 1), 0)
    ws = WaveScene(scene)
    rad, segs = rtt.trace(ws, s, o, d, key, ray_idx=idx)
    want, want_segs = _todays_trace(WaveScene(scene), s, idx,
                                    o.T.contiguous(), d.T.contiguous(), key,
                                    "pallas")
    assert eager_graphs == [(id(ws), o.shape[0])]
    assert torch.equal(rad, want.T)
    assert float(segs) == float(want_segs)


# -- the C interface ----------------------------------------------------------

def test_rays_and_bounce_structs_match_ctypes():
    """rt_wave_rays (csrc/rays.cu) and rt_wave_bounce (csrc/bounce.cu):
    entry points, argument structs field by field, rays.cu built, the
    draw's device functions defined once, in draw.cuh, and defined again
    in no source."""
    import re

    from raytracer_tpu_torch.kernels import build
    assert "rays.cu" in build.SOURCES
    srcs = {name: (CSRC / name).read_text()
            for name in ("rays.cu", "bounce.cu", "wavefront.cu")}
    assert re.search(r"\bint rt_wave_rays\(", srcs["rays.cu"])
    assert re.search(r"\bint rt_wave_bounce\(", srcs["bounce.cu"])
    for name, c_name, py in (("rays.cu", "RtRaysArgs", build.RaysArgs),
                             ("bounce.cu", "RtBounceArgs",
                              build.BounceArgs)):
        assert _c_struct_fields(srcs[name], c_name) == [
            f[0] for f in py._fields_]
    assert '#include "draw.cuh"' in srcs["rays.cu"]
    draw = (CSRC / "draw.cuh").read_text()
    for fn in ("threefry", "lane_key", "lane_draw", "erfinv_xla",
               "tile_key", "tile_value"):
        assert re.search(r"\b%s\(" % fn, draw)
        for src in srcs.values():
            assert not re.search(r"__device__[^;{]*\b%s\(" % fn, src)
