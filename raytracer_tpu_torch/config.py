"""Runtime configuration: render quality knobs and the camera pose.

Same fields and defaults as ``raytracer_tpu.config``, so a settings object
means the same render in both packages. Settings that the PyTorch port does
not serve yet raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Reference defaults (src/main.cu:13, src/main.cu:318-330).
SKY_COLOUR = (0.8, 1.0, 1.0)

# Antialias direction-jitter half-range (src/ray.cu:4).
ANTIALIAS_OFFSET_RANGE = 0.001

# Samplers the port serves: the megakernel (auto, mega) and the wavefront
# samplers (ops/integrator.py).
_SERVED_SAMPLERS = ("auto", "mega", "scan", "regen", "rebin", "lanesort")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Quality knobs (reference: src/main.cu:299-331).

    - ``emissive_terminates``: the reference keeps bouncing after hitting an
      emissive surface (src/raytracer.cu:86-90); True terminates the path.
    - ``fix_exit_ior``: the reference forgets the outer medium's IOR when a
      ray exits glass (src/ray.cu:84-98); True restores n2 = 1 on exit.
    - ``gamma``: None writes linear floats straight to u8 like the
      reference (src/main.cu:343-371); e.g. 2.2 gamma-corrects.
    - ``pixpack``: pixels per megakernel lane. None = the Renderer's auto
      policy (8 when rays_per_pixel <= 32, else 1). The estimator per pixel
      is unchanged; the pixel -> (tile, lane) assignment, hence the random
      stream a pixel sees, is not.
    - ``russian_roulette``: 0 = off (reference-faithful); N >= 1 kills
      paths after N bounces with p = clamp(max(throughput), 0.05, 1).
    """

    reflect_limit: int = 5
    rays_per_pixel: int = 100
    antialias: bool = True
    sky_colour: Tuple[float, float, float] = SKY_COLOUR
    sampler: str = "auto"
    coherent: Optional[bool] = None
    emissive_terminates: bool = False
    fix_exit_ior: bool = False
    gamma: Optional[float] = None
    pixpack: Optional[int] = None
    russian_roulette: int = 0

    def __post_init__(self):
        if self.coherent:
            raise NotImplementedError(
                "coherent=True (tile-shared scatter sampling) is not ported "
                "yet: ROADMAP item 11")
        if self.sampler not in _SERVED_SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r}; use one "
                             f"of {_SERVED_SAMPLERS}")

    def with_sky(self, use_sky: bool) -> "RenderSettings":
        """Cornell-box scenes zero the sky (src/main.cu:325-329)."""
        sky = self.sky_colour if use_sky else (0.0, 0.0, 0.0)
        return dataclasses.replace(self, sky_colour=sky)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera pose and film size (reference: src/camera.cu:4-5,34-41)."""

    width: int = 1000
    height: int = 800

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fov_deg: float = 60.0
    focal_len: float = 0.1

    x_rot: float = 0.0  # radians
    y_rot: float = 0.0
    z_rot: float = 0.0

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def fov_rad(self) -> float:
        return self.fov_deg * math.pi / 180.0

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
