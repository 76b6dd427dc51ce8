"""The wavefront samplers' bounce after the hit: ``rt_wave_bounce``.

Everything one bounce of a wavefront lane does once K5 / K6 have found
its hit: the resolve (``intersect_cuda.resolve``: the t rescale, the
point, the normal and the sphere UV, on the hit kernel's raw outputs),
the sky on a miss, the emission, the material lookup (ops/tables.py), the
texture (ops/textures.py), the scatter (ops/scatter.py) and russian
roulette (raytracer_tpu/ops/integrator.py:59-126); in the regen arm also
the regeneration bookkeeping (:251-355): the path end, the pixel sum, the
sample and bounce counters, the restart on the lane's primary ray and the
parking of a lane whose last sample ends (far away, where a hit kernel
launched without the regen loop's mask walks along the ray set-up's
``PARK_UNIT`` and enters no box). A lane
that enters the bounce finished (``sample_i >= rays_per_pixel``) keeps its
state. The scan arm keeps an alive mask and does no regeneration. The
draws and the antialias jitter come before the hit, from the ray set-up
(ops/rays.py), and the bounce reads their result.

The lane state is a dict of tensors: ``o``, ``d``, ``thru``, ``rad``
((3, N) float32) and ``cur_ior`` ((N,) float32); the scan arm adds
``alive`` ((N,) bool), the regen arm ``pixel_sum`` ((3, N)),
``sample_i`` and ``bounce_i`` ((N,) int32) and the primary rays ``o0p``
and ``d0p`` ((3, N)).

``wave_bounce_reference`` is the plain version: ``intersect_cuda.resolve``
then ``shade_bounce_reference``, the port's torch ops in their order
before the kernel existed (the JAX oracles' route, which resolves its own
hits, calls the latter alone); the ``"plain"`` route and CPU tensors take
it. On a CUDA tensor ``wave_bounce`` launches the CUDA kernel
``rt_wave_bounce`` (csrc/bounce.cu), one thread a lane, which updates the
state in place (``inplace=True``, how a replayed graph keeps its state in
its static buffers) or in copies; it raises rather than fall back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..models.materials import MAT_EMISSIVE
from .intersect_cuda import _K5_DTYPES, _K6_DTYPES, resolve
from .scatter import scatter
from .tables import lookup_material
from .textures import sample_texture

PARK_ORIGIN = 1e13
# the state keys each arm writes
_WRITES = {False: ("o", "d", "thru", "rad", "cur_ior", "alive"),
           True: ("o", "d", "thru", "rad", "cur_ior", "pixel_sum",
                  "sample_i", "bounce_i")}


def shade_bounce_reference(scene, settings, st: dict, dj: torch.Tensor,
                           hit: torch.Tensor, shade, gauss: torch.Tensor,
                           fresnel_u: torch.Tensor, rr_u=None, *,
                           regen: bool = False, bounce: int = 0) -> dict:
    """The bounce on a resolved hit: the new lane state (a dict of new
    tensors holding the keys the arm writes).

    ``dj``: the (3, N) directions the hit was traced along (the state's
    ``d`` after the antialias jitter); ``hit``, ``shade``: the
    HitRecord's hit mask and the ShadeData of the resolve;
    ``gauss`` (3, N), ``fresnel_u`` (N,) and ``rr_u`` (N,) or None: the
    lane randoms. ``regen``: the regen arm, whose lanes are active while
    ``sample_i < rays_per_pixel``, which parks a lane whose last sample
    ends here and leaves a lane that enters finished as it was; else the
    scan arm, whose ``bounce`` is the bounce index russian roulette
    reads."""
    o, thru, rad, cur_ior = st["o"], st["thru"], st["rad"], st["cur_ior"]
    if regen:
        alive = st["sample_i"] < settings.rays_per_pixel
        bounces_done = st["bounce_i"]
    else:
        alive = st["alive"]
        bounces_done = bounce
    sky = torch.tensor(settings.sky_colour, dtype=torch.float32,
                       device=o.device)[:, None]
    d = dj

    # a miss adds the sky and ends the path (src/raytracer.cu:76-80)
    miss = alive & ~hit
    rad = rad + torch.where(miss[None, :], thru * sky, 0.0)

    cols = lookup_material(scene, shade.mat_id)
    is_emissive = cols.mat_type == MAT_EMISSIVE
    live_hit = alive & hit
    # emission adds, else the throughput takes the texture colour
    # (src/raytracer.cu:86-90)
    rad = rad + torch.where((live_hit & is_emissive)[None, :],
                            thru * cols.emit, 0.0)
    tex = sample_texture(scene, cols, shade.u, shade.v, shade.colour)
    thru = torch.where((live_hit & ~is_emissive)[None, :], thru * tex, thru)

    new_d, new_ior = scatter(
        gauss, fresnel_u, d, shade.normal, cols.mat_type, shade.smooth,
        cols.ior, cur_ior, fix_exit_ior=settings.fix_exit_ior,
        has_refractive=bool(scene.has_refractive))
    o = torch.where(live_hit[None, :], shade.point, o)
    d = torch.where(live_hit[None, :], new_d, d)
    cur_ior = torch.where(live_hit, new_ior, cur_ior)

    path_continues = live_hit
    if settings.emissive_terminates:
        path_continues = path_continues & ~is_emissive
    if rr_u is not None:
        p = torch.clamp(thru.amax(dim=0), 0.05, 1.0)
        eligible = path_continues & (
            bounces_done + 1 >= settings.russian_roulette)
        survive = rr_u < p
        thru = torch.where((eligible & survive)[None, :], thru / p[None, :],
                           thru)
        path_continues = path_continues & ~(eligible & ~survive)
    if not regen:
        return {"o": o, "d": d, "thru": thru, "rad": rad,
                "cur_ior": cur_ior, "alive": path_continues}

    spp = settings.rays_per_pixel
    sample_i, bounce_i = st["sample_i"], st["bounce_i"]
    active = alive
    # a path ends on a miss or termination, or at the bounce limit
    path_end = active & (~path_continues
                         | (bounce_i + 1 >= settings.reflect_limit))
    pixel_sum = st["pixel_sum"] + torch.where(path_end[None, :], rad, 0.0)

    # regenerate finished lanes onto their next sample
    sample_i = torch.where(path_end, sample_i + 1, sample_i)
    bounce_i = torch.where(path_end, 0,
                           torch.where(active, bounce_i + 1, bounce_i))
    restart = path_end[None, :]
    o = torch.where(restart, st["o0p"], o)
    d = torch.where(restart, st["d0p"], d)
    thru = torch.where(restart, 1.0, thru)
    rad = torch.where(restart, 0.0, rad)
    cur_ior = torch.where(path_end, 1.0, cur_ior)
    # park finished lanes far away (rebin / lanesort bucket them by d)
    done = sample_i >= spp
    park_d = torch.tensor([1.0, 0.0, 0.0], device=o.device)[:, None]
    o = torch.where(done[None, :], PARK_ORIGIN, o)
    d = torch.where(done[None, :], park_d, d)
    out = {"o": o, "d": d, "thru": thru, "rad": rad, "cur_ior": cur_ior,
           "pixel_sum": pixel_sum, "sample_i": sample_i,
           "bounce_i": bounce_i}
    # a lane that entered finished keeps its state, as in rt_wave_bounce
    return {k: torch.where(active if x.dim() == 1 else active[None, :], x,
                           st[k]) for k, x in out.items()}


def wave_bounce_reference(scene, settings, st: dict, dj: torch.Tensor,
                          raw, inv_len: torch.Tensor, gauss: torch.Tensor,
                          fresnel_u: torch.Tensor, rr_u=None, *,
                          regen: bool = False, bounce: int = 0) -> dict:
    """Plain version of ``rt_wave_bounce``: ``intersect_cuda.resolve`` of
    the hit kernel's raw outputs ``raw`` (K5's 12 or K6's 9, from the
    state's ``o`` along ``dj``'s unit direction, ``inv_len`` = 1 / |dj|,
    the sphere UV when ``scene.needs_sphere_uv``), then
    ``shade_bounce_reference`` (the other arguments and the result)."""
    rec, shade = resolve(raw, st["o"], dj, inv_len,
                         bool(scene.needs_sphere_uv))
    return shade_bounce_reference(scene, settings, st, dj, rec.hit, shade,
                                  gauss, fresnel_u, rr_u, regen=regen,
                                  bounce=bounce)


def _rows(x: torch.Tensor, rows: int, what: str):
    """Row pointers of a (rows, N) float32 tensor whose rows are
    contiguous."""
    if x.dim() != 2 or x.shape[0] != rows or x.stride(1) != 1:
        raise ValueError(f"{what} must be ({rows}, N) with contiguous "
                         f"rows, got {tuple(x.shape)}")
    return [x[r].data_ptr() for r in range(rows)]


def _ptr(x: torch.Tensor, dtype, what: str) -> int:
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype}, got "
                         f"{x.dtype}")
    return x.data_ptr()


# the raw outputs' dtypes by count: K5's 12, K6's 9
_RAW_DTYPES = {12: _K5_DTYPES, 9: _K6_DTYPES}


def bounce_args(scene, settings, st, dj, raw, inv_len, gauss, fresnel_u,
                rr_u=None, *, regen: bool = False, bounce: int = 0):
    """``rt_wave_bounce``'s argument struct over the state ``st`` (updated
    in place by the launch) and this bounce's inputs; checks what the
    kernel reads. The caller keeps the tensors alive across the launch."""
    f32, i32 = torch.float32, torch.int32
    n = st["o"].shape[1]
    if len(raw) not in _RAW_DTYPES:
        raise ValueError(f"raw must hold K5's 12 or K6's 9 outputs, got "
                         f"{len(raw)}")
    for k, (x, dtype) in enumerate(zip(raw, _RAW_DTYPES[len(raw)])):
        if x.shape != (n,) or x.device != st["o"].device:
            raise ValueError(f"raw output {k} must be ({n},) on "
                             f"{st['o'].device}")
        _ptr(x, dtype, f"raw output {k}")
    for name, x in (("inv_len", inv_len), ("fresnel_u", fresnel_u)):
        if x.shape != (n,) or x.device != st["o"].device:
            raise ValueError(f"{name} must be ({n},) on {st['o'].device}")
    args = build.BounceArgs()
    for name in ("o", "d", "thru", "rad"):
        getattr(args, name)[:] = _rows(st[name], 3, name)
    args.ior = _ptr(st["cur_ior"], f32, "cur_ior")
    if regen:
        args.pixel_sum[:] = _rows(st["pixel_sum"], 3, "pixel_sum")
        args.sample = _ptr(st["sample_i"], i32, "sample_i")
        args.bounce = _ptr(st["bounce_i"], i32, "bounce_i")
        args.o0p[:] = _rows(st["o0p"], 3, "o0p")
        args.d0p[:] = _rows(st["d0p"], 3, "d0p")
    else:
        args.alive = _ptr(st["alive"], torch.bool, "alive")
    args.dj[:] = _rows(dj, 3, "dj")
    args.raw[:len(raw)] = [x.data_ptr() for x in raw]
    args.inv_len = _ptr(inv_len, f32, "inv_len")
    args.gauss[:] = _rows(gauss, 3, "gauss")
    args.fresnel = _ptr(fresnel_u, f32, "fresnel_u")
    args.rr = None if rr_u is None else _ptr(rr_u, f32, "rr_u")
    for name, attr, dtype in (
            ("mat_type", "mat_type", i32), ("mat_ior", "mat_ior", f32),
            ("mat_emit", "mat_emit", f32), ("tex_type", "tex_type", i32),
            ("tex_light", "tex_light", f32), ("tex_dark", "tex_dark", f32),
            ("tex_nsq", "tex_nsq", f32), ("tex_offset", "tex_off", i32),
            ("tex_width", "tex_w", i32), ("tex_height", "tex_h", i32),
            ("atlas", "atlas", f32)):
        setattr(args, attr, _ptr(getattr(scene, name), dtype, name))
    args.atlas_rows = int(scene.atlas.shape[0])
    args.sky[:] = [float(x) for x in
                   np.asarray(settings.sky_colour, np.float32)]
    args.n = n
    args.bounce_const = int(bounce)
    args.rr_start = int(settings.russian_roulette) if rr_u is not None \
        else 0
    args.limit = int(settings.reflect_limit)
    args.spp = int(settings.rays_per_pixel)
    args.fix_exit_ior = int(settings.fix_exit_ior)
    args.has_refractive = int(bool(scene.has_refractive))
    args.emissive_terminates = int(settings.emissive_terminates)
    args.regen = int(regen)
    args.blocked = int(len(raw) == 9)
    args.sphere_uv = int(bool(scene.needs_sphere_uv))
    return args


def _wave_bounce_cuda(scene, settings, st, *args, **kw) -> None:
    """Launch rt_wave_bounce (``bounce_args``' arguments), in place."""
    a = bounce_args(scene, settings, st, *args, **kw)
    build.launch("rt_wave_bounce", a, st["o"].device)


def wave_bounce(scene, settings, st: dict, dj, raw, inv_len, gauss,
                fresnel_u, rr_u=None, *, regen: bool = False,
                bounce: int = 0, plain: bool = False,
                inplace: bool = False) -> dict:
    """One bounce after the hit (arguments as ``wave_bounce_reference``):
    the new lane state, the keys the arm writes. CPU tensors, or
    ``plain=True`` on any device, take ``wave_bounce_reference``; CUDA
    tensors launch ``rt_wave_bounce`` (or raise). With ``inplace=True``
    the state's own tensors are updated and returned (the static tensors
    of a captured graph), else new ones."""
    dev = st["o"].device
    if dev.type == "cpu" or plain:
        out = wave_bounce_reference(scene, settings, st, dj, raw, inv_len,
                                    gauss, fresnel_u, rr_u, regen=regen,
                                    bounce=bounce)
        if not inplace:
            return out
        for k, x in out.items():
            st[k].copy_(x)
        return {k: st[k] for k in out}
    if dev.type != "cuda":
        raise ValueError(f"no bounce kernel for device {dev}")
    out = {k: st[k] if inplace else st[k].clone() for k in _WRITES[regen]}
    _wave_bounce_cuda(scene, settings, {**st, **out}, dj, raw, inv_len,
                      gauss, fresnel_u, rr_u, regen=regen, bounce=bounce)
    return out
