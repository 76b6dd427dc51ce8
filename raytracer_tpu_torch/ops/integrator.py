"""Progressive frame integration: the megakernel and the wavefront samplers.

Port of ``raytracer_tpu/ops/integrator.py``. ``auto`` and ``mega`` take the
megakernel (ops/megakernel.py). The wavefront samplers hold the frame's
rays as (3, N) tensors and run one bounce of every lane per step:

- ``scan``: spp samples, each a fixed ``reflect_limit`` bounces with an
  alive mask (``_trace_soa``; one sample of it is the public ``trace``),
  the transcription of the reference's nested loops
  (src/raytracer.cu:71,102);
- ``regen``: one loop in which a lane whose path ends restarts on its
  pixel's next sample (``_render_regen_soa``);
- ``rebin`` / ``lanesort``: regen with the lanes regrouped by origin cell
  and direction octant after every bounce, by 128-lane rows or by ray
  (ops/rebin.py). Random streams are keyed by pixel and ride the
  permutation, and the pixel sums are un-permuted at the end, so both are
  bitwise equal to regen (not with ``coherent``, whose draws belong to
  the lane position).

Randomness is keyed by the global pixel index ``ray_idx`` (the Renderer
passes its Morton order), sample and bounce (ops/rng.py). ``backend``
takes the JAX names: ``"pallas"`` (default) is the kernel route, on a
CUDA tensor three kernels an iteration: the ray set-up ``rt_wave_rays``
(ops/rays.py: the draw, per lane or coherent sampling's per tile, the
antialias jitter, the unit directions, the segment count), K5 or K6
(ops/intersect_cuda.py) and ``rt_wave_bounce``
(ops/bounce.py: the resolve and the bounce), their plain versions on a
CPU tensor; ``"xla"`` and ``"woop"`` are the JAX package's CPU oracles
(ops/intersect.py). ``"plain"`` is the kernel route with every kernel
replaced by its plain version, on any device: the card holds the kernel
route against it.

On a CUDA tensor the kernel route runs as the JAX package's compiled
loop does, without the host between iterations: the iterations are
captured once into CUDA graphs on static tensors and replayed
(ops/wave_graph.py). ``_RegenGraphs`` holds one graph of
EXIT_CHECK_EVERY regen / rebin / lanesort iterations (and one of the rest
up to the ``spp * reflect_limit`` cap), ``_ScanGraph`` one sample of the
scan sampler and of ``trace``; both live in the WaveScene's cache. Every
other route runs the same iteration functions eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RenderSettings
from ..utils.trace import span
from . import film, intersect, rng, wave_graph
from .bounce import shade_bounce_reference, wave_bounce
from .intersect_cuda import WaveScene, hit_raw
from .megakernel import MegaScene, render_sample_mean_mega
from .rays import wave_rays
from .rebin import (LANES, apply_lane_permutation, bucket_permutation,
                    lane_buckets, lane_destinations, permute_rows,
                    row_buckets)

BACKENDS = ("pallas", "plain", "xla", "woop")
# The regen loop looks for its end every this many iterations: each look
# is a host sync on the card, and an iteration with no active lane changes
# nothing. On the card each look is followed by the replay of one graph of
# this many iterations (or of the rest up to the cap).
EXIT_CHECK_EVERY = 8
# what rebin and lanesort regroup each iteration, besides ``home``
_REGROUPED = ("o", "d", "thru", "rad", "pixel_sum", "o0p", "d0p",
              "cur_ior", "kd", "bounce_i", "sample_i")


@dataclasses.dataclass
class _Route:
    """What a wavefront call's iterations read besides the lane state.
    ``graph``: the iterations are captured into a CUDA graph (the kernel
    route on the card): the state stays in its static tensors, updated in
    place, and the coherent draw takes its key and iteration from device
    memory. ``tile_key``: the eager coherent draw's key."""

    ws: WaveScene
    settings: RenderSettings
    backend: str
    graph: bool = False
    tile_key: np.ndarray = None

    @property
    def plain(self) -> bool:
        return self.backend == "plain"

    @property
    def use_rr(self) -> bool:
        return self.settings.russian_roulette > 0


def _replays(backend: str, o: torch.Tensor) -> bool:
    """Whether a call runs as replayed CUDA graphs: the kernel route on a
    CUDA tensor. The plain route, the oracles and CPU tensors run eagerly."""
    return backend == "pallas" and o.device.type == "cuda"


def _rays(route: _Route, st: dict, **kw):
    """The iteration's ray set-up (``wave_rays``) on the state's
    directions, counting its segments into ``st["segs"]``."""
    s = route.settings
    return wave_rays(st["d"], antialias=s.antialias, with_rr=route.use_rr,
                     segs=st["segs"], spp=s.rays_per_pixel, plain=route.plain,
                     **kw)


def _bounce(route: _Route, st: dict, rays, *, regen: bool,
            bounce: int = 0, park: bool = False) -> None:
    """One bounce of every lane of ``st`` (integrator.py:59-126) on the
    iteration's ``rays`` (``wave_rays``): the nearest hit (K5 / K6 on the
    kernel route, their raw outputs), then ``wave_bounce``
    (``rt_wave_bounce``: the resolve and the bounce). The oracles resolve
    their own hits (ops/intersect.py) and take ``shade_bounce_reference``."""
    settings, ws = route.settings, route.ws
    scene = ws.scene
    kw = dict(regen=regen, bounce=bounce, park=park)
    if route.backend in ("pallas", "plain"):
        raw = hit_raw(ws, st["o"], rays.unit, plain=route.plain)
        st.update(wave_bounce(
            scene, settings, st, rays.dj, raw, rays.inv_len, rays.gauss,
            rays.fresnel, rays.rr, plain=route.plain, inplace=route.graph,
            **kw))
        return
    rec = intersect.nearest_hit(st["o"], rays.dj, scene,
                                backend=route.backend)
    shade = intersect.resolve_hit(st["o"], rays.dj, scene, rec)
    st.update(shade_bounce_reference(scene, settings, st, rays.dj, rec.hit,
                                     shade, rays.gauss, rays.fresnel,
                                     rays.rr, **kw))


def _trace_iterations(route: _Route, st: dict, keys: torch.Tensor) -> None:
    """One sample's ``reflect_limit`` bounces with an alive mask on the
    lane state ``st`` (integrator.py:148-187), counting live segments into
    ``st["segs"]``; ``keys``: the per-ray keys of the sample."""
    for b in range(route.settings.reflect_limit):
        rays = _rays(route, st, keys=keys, bounce=b, alive=st["alive"])
        _bounce(route, st, rays, regen=False, bounce=b)


def _scan_state(o: torch.Tensor, d: torch.Tensor) -> dict:
    n = o.shape[1]
    return {"o": o, "d": d, "thru": torch.ones_like(o),
            "rad": torch.zeros_like(o),
            "alive": torch.ones(n, dtype=torch.bool, device=o.device),
            "cur_ior": torch.ones(n, dtype=torch.float32, device=o.device),
            "segs": torch.zeros((), dtype=torch.int64, device=o.device)}


class _ScanGraph:
    """One sample of the scan sampler (and of ``trace``) captured on
    static tensors: the primary rays, the sample's key and the pixel
    indices in; the radiance and the live segments out. The graph derives
    the per-ray keys from the key in device memory, so one capture serves
    every sample, frame and camera of its shape."""

    def __init__(self, route: _Route, n: int):
        dev = route.ws.device
        self.o0 = torch.empty((3, n), dtype=torch.float32, device=dev)
        self.d0 = torch.empty_like(self.o0)
        self.key = torch.zeros(2, dtype=torch.int64, device=dev)
        self.ray_idx = torch.zeros(n, dtype=torch.int64, device=dev)
        self.st = _scan_state(self.o0.clone(), self.d0.clone())

        def body():
            st = self.st
            st["o"].copy_(self.o0)
            st["d"].copy_(self.d0)
            st["thru"].fill_(1.0)
            st["rad"].zero_()
            st["alive"].fill_(True)
            st["cur_ior"].fill_(1.0)
            st["segs"].zero_()
            _trace_iterations(route, st,
                              rng.per_ray_keys(self.key, self.ray_idx))
        self.graph = wave_graph.capture(route.ws, n, body)

    def run(self, o: torch.Tensor, d: torch.Tensor, key: np.ndarray,
            ray_idx: torch.Tensor):
        """Replay one sample; the outputs are the static tensors, which
        the next replay overwrites."""
        self.o0.copy_(o)
        self.d0.copy_(d)
        self.ray_idx.copy_(ray_idx)
        rng.set_key(self.key, key)
        self.graph.replay()
        return self.st["rad"], self.st["segs"]


def _trace_soa(ws: WaveScene, settings: RenderSettings, ray_idx, o, d,
               key: np.ndarray, backend: str):
    """One sample for every (3, N) ray: ``reflect_limit`` bounces with an
    alive mask (integrator.py:148-187). Returns ((3, N) radiance, int64
    count of live segments); on the card the replayed graph's own
    tensors, valid until the next replay of the same shape."""
    route = _Route(ws, settings, backend)
    if _replays(backend, o):
        route.graph = True
        cache_key = ("scan", o.shape[1], settings, backend)
        if cache_key not in ws.graphs:
            ws.graphs[cache_key] = _ScanGraph(route, o.shape[1])
        return ws.graphs[cache_key].run(o, d, key, ray_idx)
    st = _scan_state(o, d)
    _trace_iterations(route, st, rng.per_ray_keys(key, ray_idx))
    return st["rad"], st["segs"]


def _wave_inputs(scene, o: torch.Tensor, ray_idx, backend: str):
    """(WaveScene, ray_idx) of a wavefront call: ``scene`` packed unless
    it already is, ``ray_idx`` 0..N-1 on the rays' device unless given;
    raises for an unknown ``backend``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")
    ws = scene if isinstance(scene, WaveScene) else WaveScene(scene)
    if ray_idx is None:
        ray_idx = torch.arange(o.shape[0], dtype=torch.int32,
                               device=o.device)
    return ws, ray_idx


def trace(scene, settings: RenderSettings, o: torch.Tensor,
          d: torch.Tensor, key: np.ndarray, ray_idx=None,
          backend: str = "pallas"):
    """Trace one sample for every ray (``trace_ray``,
    src/raytracer.cu:67-94): ``reflect_limit`` bounces with an alive mask.
    ``o``/``d`` are (N, 3); returns ((N, 3) radiance, the live segments
    traced as a float64 0-dim tensor).

    JAX's ``trace(scene, settings, ray_idx, o, d, key, backend="woop")``
    (integrator.py:129) takes its arguments in another order; here they
    follow ``render_sample_mean``: ``key`` is the sample key's data
    (``rng.key``, ``rng.fold_in``; ``jax.random.key_data`` of JAX's key),
    ``ray_idx`` the (N,) global pixel indices that key the per-ray streams
    (default 0..N-1), and ``backend`` defaults to the kernel route: on a
    CUDA tensor every bounce launches ``rt_wave_rays``, K5
    (``rt_hit_resolve``, or K6 for a scene over the resident budget) and
    ``rt_wave_bounce``, replayed from a CUDA graph that the WaveScene
    caches per shape and settings; ``"plain"`` runs their plain versions
    on any device, ``"xla"`` and ``"woop"`` are JAX's CPU oracles.
    ``scene`` is a SceneArrays or a WaveScene built from one: pass the
    WaveScene to replay its graph, a SceneArrays is packed (and on the
    card captured) anew each call."""
    ws, ray_idx = _wave_inputs(scene, o, ray_idx, backend)
    rad, segs = _trace_soa(ws, settings, ray_idx, o.T.contiguous(),
                           d.T.contiguous(), key, backend)
    return rad.T.clone(), segs.to(torch.float64)


def _regen_state(o0: torch.Tensor, d0: torch.Tensor, kd: torch.Tensor,
                 home_size=None) -> dict:
    n = o0.shape[1]
    dev = o0.device
    st = {"o": o0, "d": d0, "o0p": o0, "d0p": d0,
          "thru": torch.ones_like(o0), "rad": torch.zeros_like(o0),
          "pixel_sum": torch.zeros_like(o0),
          "bounce_i": torch.zeros(n, dtype=torch.int32, device=dev),
          "sample_i": torch.zeros(n, dtype=torch.int32, device=dev),
          "cur_ior": torch.ones(n, dtype=torch.float32, device=dev),
          "kd": kd, "segs": torch.zeros((), dtype=torch.int64, device=dev)}
    if home_size is not None:
        st["home"] = torch.arange(home_size, dtype=torch.int64, device=dev)
    return st


def _regen_iteration(route: _Route, st: dict, it: int, rebin: bool,
                     lane_sort: bool) -> None:
    """One iteration of the regen loop (integrator.py:251-355) on the lane
    state ``st``: every active lane bounces once, a lane whose path ends
    restarts on its pixel's next sample (``rt_wave_bounce``'s regen arm),
    then rebin / lanesort regroup the lanes. ``it`` counts iterations from
    0 and keys the eager coherent draw; a captured iteration reads it from
    ``st["it"]`` and the ray set-up counts it there."""
    settings = route.settings
    spp = settings.rays_per_pixel
    if settings.coherent and route.graph:
        # the kernel reads the key and counter and advances the counter
        rays = _rays(route, st, key_dev=st["key"], iter_dev=st["it"],
                     sample_i=st["sample_i"])
    elif settings.coherent:
        rays = _rays(route, st, tile_key=rng.fold_in(route.tile_key, it),
                     sample_i=st["sample_i"])
    else:
        rays = _rays(route, st, keys=st["kd"], sample_i=st["sample_i"],
                     bounce=st["bounce_i"])
    _bounce(route, st, rays, regen=True, park=rebin or lane_sort)
    if not (rebin or lane_sort):
        return
    done = st["sample_i"] >= spp
    if lane_sort:
        dest = lane_destinations(lane_buckets(st["o"], st["d"], done))
        moved = apply_lane_permutation(
            dest, [st[k] for k in _REGROUPED + ("home",)])
    else:
        perm = bucket_permutation(row_buckets(st["o"], st["d"], done))
        moved = [permute_rows(perm, st[k]) for k in _REGROUPED] + [
            st["home"][perm]]
    for k, x in zip(_REGROUPED + ("home",), moved):
        if route.graph:
            st[k].copy_(x)
        else:
            st[k] = x


class _RegenGraphs:
    """The regen, rebin and lanesort iterations of one call shape,
    captured on static lane state: a graph of EXIT_CHECK_EVERY iterations
    and, where ``spp * reflect_limit`` is not a multiple of it, one of the
    rest. The primary rays, the per-pixel keys, the coherent tile key and
    the iteration counter live in device memory, so one capture serves
    every frame and camera of its shape."""

    def __init__(self, route: _Route, n: int, rebin: bool, lane_sort: bool):
        dev = route.ws.device
        self.route, self.rebin, self.lane_sort = route, rebin, lane_sort
        def rows():
            return torch.empty((3, n), dtype=torch.float32, device=dev)
        home = None
        if rebin or lane_sort:
            home = n if lane_sort else n // LANES
        self.st = _regen_state(
            rows(), rows(),
            torch.zeros((2, n), dtype=torch.int64, device=dev), home)
        self.st.update(o0p=rows(), d0p=rows(),
                       key=torch.zeros(2, dtype=torch.int64, device=dev),
                       # the coherent iteration and its ray set-up's ticket
                       it=torch.zeros(2, dtype=torch.int64, device=dev))
        self.graphs: dict = {}

    def reset(self, o0, d0, kd, tile_key) -> None:
        """The frame's start: every lane on its first sample."""
        st = self.st
        for k, x in (("o", o0), ("d", d0), ("o0p", o0), ("d0p", d0),
                     ("kd", kd)):
            st[k].copy_(x)
        st["thru"].fill_(1.0)
        st["cur_ior"].fill_(1.0)
        for k in ("rad", "pixel_sum", "bounce_i", "sample_i", "segs", "it"):
            st[k].zero_()
        if "home" in st:
            torch.arange(st["home"].shape[0], out=st["home"])
        if tile_key is not None:
            rng.set_key(st["key"], tile_key)

    def step(self, it: int, k: int) -> None:
        """Replay ``k`` iterations (captured on first use)."""
        if k not in self.graphs:
            def body():
                for _ in range(k):
                    _regen_iteration(self.route, self.st, 0, self.rebin,
                                     self.lane_sort)
            self.graphs[k] = wave_graph.capture(self.route.ws,
                                                self.st["o"].shape[1], body)
        self.graphs[k].replay()


def _render_regen_soa(ws: WaveScene, settings: RenderSettings, ray_idx,
                      o0, d0, frame_key: np.ndarray, backend: str,
                      rebin: bool = False, lane_sort: bool = False,
                      tile_offset: int = 0):
    """Path-regeneration sampler (integrator.py:190-366): each lane owns
    one pixel and restarts on the pixel's next sample when its path ends.
    Returns ((3, N) mean, int64 segments).

    With ``settings.coherent`` every iteration draws the tile bundles of
    ``rng.tile_randoms`` (inside ``rt_wave_rays`` on the card) under
    ``fold_in(fold_in(frame_key, tile_offset), it)``, ``it`` counting
    iterations from 0 (integrator.py:257-269). Those draws belong to the
    lane position, not to the lane's pixel: they do not ride the rebin /
    lanesort permutation (only the per-pixel keys do, :271-274), so
    coherent rebin and lanesort differ from coherent regen, as in JAX.

    On the card (the kernel route) the iterations replay CUDA graphs that
    ``ws`` caches per (N, settings, backend): one of EXIT_CHECK_EVERY
    iterations between two looks for the end, as the eager loop looks."""
    spp = settings.rays_per_pixel
    cap = spp * settings.reflect_limit
    n = o0.shape[1]
    dev = o0.device
    lane_sort = bool(lane_sort) and n % LANES == 0 and n // LANES >= 8
    rebin = (bool(rebin) and not lane_sort
             and n % LANES == 0 and n // LANES >= 8)
    tile_key = rng.fold_in(frame_key, tile_offset) if settings.coherent \
        else None
    with span("regen.keys"):
        kd = rng.per_ray_keys(frame_key, ray_idx)
    route = _Route(ws, settings, backend, tile_key=tile_key)

    if _replays(backend, o0):
        route.graph = True
        cache_key = ("regen", n, settings, backend)
        if cache_key not in ws.graphs:
            ws.graphs[cache_key] = _RegenGraphs(route, n, rebin, lane_sort)
        runner = ws.graphs[cache_key]
        with span("regen.reset"):
            runner.reset(o0, d0, kd, tile_key)
        st, step = runner.st, runner.step
    else:
        home = None
        if rebin or lane_sort:
            home = n if lane_sort else n // LANES
        with span("regen.reset"):
            st = _regen_state(o0, d0, kd, home)

        def step(it, k):
            for j in range(k):
                _regen_iteration(route, st, it + j, rebin, lane_sort)

    it = 0
    while it < cap:
        with span("regen.check"):
            more = bool((st["sample_i"] < spp).any())
        if not more:
            break
        k = min(EXIT_CHECK_EVERY, cap - it)
        with span("regen.replay"):
            step(it, k)
        it += k

    with span("regen.finish"):
        pixel_sum = st["pixel_sum"]
        if lane_sort:
            # home[current lane] = original lane
            out = torch.empty_like(pixel_sum)
            out[:, st["home"]] = pixel_sum
            pixel_sum = out
        elif rebin:
            unperm = torch.empty_like(st["home"])
            unperm[st["home"]] = torch.arange(st["home"].shape[0],
                                              device=dev)
            pixel_sum = permute_rows(unperm, pixel_sum)
        spp_t = torch.full((), float(spp), dtype=torch.float32, device=dev)
        return pixel_sum / spp_t, st["segs"].clone()


def render_sample_mean(scene, settings: RenderSettings, o: torch.Tensor,
                       d: torch.Tensor, frame_key: np.ndarray,
                       tile_offset: int = 0, ray_idx=None,
                       backend: str = "pallas"):
    """Mean of ``rays_per_pixel`` paths per primary ray
    (src/raytracer.cu:97-107). ``o``/``d`` are (N, 3); returns ((N, 3)
    mean, segment count as a float64 0-dim tensor).

    ``scene``: a SceneArrays, or the holder the sampler reads (MegaScene
    for ``auto``/``mega``, WaveScene for the wavefront samplers), built
    once per scene. ``ray_idx``: (N,) global pixel indices that key the
    wavefront streams (default 0..N-1). ``tile_offset`` globalises the
    megakernel's tile ids and keys the coherent regen draws; the other
    wavefront streams are keyed by pixel. The scan sampler has no coherent
    draw, in JAX as here.

    ``auto`` and ``mega`` take the megakernel, for every scene. The JAX
    ``auto`` sends two kinds of scene to its wavefront pipeline instead:
    image planes past 2048 packed rows and scenes over the TPU's SMEM
    budget (megakernel.py:166-206). Both thresholds were measured on the
    TPU, whose kernel keeps scene and texels in on-chip memory; a thread
    on the card reads both from global memory, so neither cliff is
    carried over."""
    if settings.sampler in ("auto", "mega"):
        ms = scene if isinstance(scene, MegaScene) else MegaScene(scene)
        mean, segs = render_sample_mean_mega(ms, settings, o.T, d.T,
                                             frame_key,
                                             tile_offset=tile_offset)
        return mean.T, segs
    ws, ray_idx = _wave_inputs(scene, o, ray_idx, backend)
    o3, d3 = o.T.contiguous(), d.T.contiguous()
    if settings.sampler in ("regen", "rebin", "lanesort"):
        mean, segs = _render_regen_soa(
            ws, settings, ray_idx, o3, d3, frame_key, backend,
            rebin=settings.sampler == "rebin",
            lane_sort=settings.sampler == "lanesort",
            tile_offset=tile_offset)
    else:
        total = torch.zeros_like(o3)
        segs = torch.zeros((), dtype=torch.int64, device=o.device)
        for s in range(settings.rays_per_pixel):
            rad, n_segs = _trace_soa(ws, settings, ray_idx, o3, d3,
                                     rng.sample_key(frame_key, s), backend)
            total = total + rad
            segs = segs + n_segs
        spp_t = torch.full((), float(settings.rays_per_pixel),
                           dtype=torch.float32, device=o.device)
        mean = total / spp_t
    return mean.T, segs.to(torch.float64)


def render_frame(scene, settings: RenderSettings, o: torch.Tensor,
                 d: torch.Tensor, accum: torch.Tensor, frame_num: int,
                 base_key: np.ndarray, tile_offset: int = 0, ray_idx=None,
                 backend: str = "pallas"):
    """One progressive frame: ``accum`` becomes the running mean of all
    frames so far, updated in place (src/raytracer.cu:109-113).
    Returns (accum, traced segment count)."""
    with span("frame.key"):
        fkey = rng.frame_key(base_key, frame_num)
    mean, segs = render_sample_mean(scene, settings, o, d, fkey,
                                    tile_offset=tile_offset,
                                    ray_idx=ray_idx, backend=backend)
    with span("film.update"):
        return film.progressive_update(accum, mean, frame_num), segs
