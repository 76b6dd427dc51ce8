"""Whether what the window produced is correct: the program's outputs at
lane slots drawn from the seed against the plain reference (``pbref``),
run after the window, on the same device, once the program's state is
freed.

Each compared number is printed beside its limit (``workloads/<cell>``'s
``limits``); a run is correct when none exceeds its limit. With
``control`` the reference computed in bfloat16 takes the program's
place: the comparison has to fail it.

``validate`` refuses, before any frame, a cell whose traffic mode,
sampler or settings the reference does not model: it never judges one
path of the program by another path's reference.
"""

from __future__ import annotations

import torch

from pbref import render, wave

from . import spec

CONTROL_DTYPE = torch.bfloat16
# the program's samplers the reference models, and by which sampler
SAMPLERS = {"auto": "mega", "mega": "mega", "regen": "wave"}
# RenderSettings fields the reference takes as given ...
MODELLED = {"reflect_limit", "rays_per_pixel", "antialias", "sky_colour",
            "sampler"}
# ... and those it models at the program's default only
DEFAULT_ONLY = {"coherent": (None, False), "emissive_terminates": (False,),
                "fix_exit_ior": (False,), "gamma": (None,),
                "pixpack": (None,), "russian_roulette": (0,)}


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest absolute difference; inf where either is not finite."""
    a, b = a.double().cpu(), b.double().cpu()
    if a.shape != b.shape:
        return float("inf")
    d = (a - b).abs()
    if not torch.isfinite(d).all():
        return float("inf")
    return float(d.max()) if d.numel() else 0.0


def validate(cell) -> None:
    """Raise unless the reference models the cell's mode, sampler and
    every settings field it gives the program."""
    mode = cell.traffic["mode"]
    if mode not in CHECKS:
        raise ValueError(f"the reference checks no mode {mode!r}")
    for k, v in spec.render_settings(cell).items():
        if k == "sampler" and v not in SAMPLERS:
            raise ValueError(f"the reference models no sampler {v!r}; "
                             f"samplers: {sorted(SAMPLERS)}")
        if k not in MODELLED and v not in DEFAULT_ONLY.get(k, ()):
            raise ValueError(f"the reference does not model {k}={v!r}")


def _setup(cell, dev, dtype):
    rs = spec.render_settings(cell)
    sc = spec.reference_scene(cell, dev).to(dev, dtype)
    sky = rs["sky_colour"] if cell.config["settings"]["use_sky"] \
        else (0.0, 0.0, 0.0)
    kw = dict(spp=rs["rays_per_pixel"], limit=rs["reflect_limit"],
              antialias=rs["antialias"], sky=sky)
    return sc, kw


def progressive(cell, win, seed: int, dev, control: bool = False) -> dict:
    """The film after every frame the harness drove, at the sampled
    pixels, by the megakernel's reference or, for the regen sampler, the
    wavefront one."""
    t = cell.traffic
    tiles, slots, k = win.checked["lanes"]
    frames = win.checked["frames"]

    def film(dtype):
        sc, kw = _setup(cell, dev, dtype)
        args = (sc, cell.config["camera"], t["width"], t["height"])
        if SAMPLERS[t["sampler"]] == "wave":
            pos = render.lane_positions(tiles, slots, k)
            return wave.progressive(
                *args, seed=seed & 0xFFFFFFFF, frames=frames,
                positions=pos[pos < t["width"] * t["height"]], dtype=dtype,
                **kw)
        ref, pix = render.progressive(
            *args, seed=seed & 0xFFFFFFFF, frames=frames, tiles=tiles,
            slots=slots, k=k, dtype=dtype, **kw)
        return ref[pix >= 0]

    ref = film(torch.float32)
    got = film(CONTROL_DTYPE) if control else win.checked["film"]
    return {"film_gap": _gap(got, ref)}


CHECKS = {"progressive": progressive}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): correct when every number is
    within its limit; a number without a limit fails."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
