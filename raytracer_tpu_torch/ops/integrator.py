"""Progressive frame integration over the megakernel sampler.

Port of the megakernel branch of ``raytracer_tpu/ops/integrator.py``
(render_sample_mean :369-412, render_frame :437-462). The wavefront
samplers (scan / regen / rebin / lanesort) are ROADMAP item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderSettings
from . import film, rng
from .megakernel import render_sample_mean_mega


def render_sample_mean(scene, settings: RenderSettings, o: torch.Tensor,
                       d: torch.Tensor, frame_key: np.ndarray,
                       tile_offset: int = 0):
    """Mean of ``rays_per_pixel`` paths per primary ray
    (src/raytracer.cu:97-107). ``o``/``d`` are (N, 3); returns
    ((N, 3) mean, segment count).

    ``auto`` and ``mega`` both take the megakernel, for every scene. The
    JAX ``auto`` sends two kinds of scene to its wavefront pipeline
    instead: image planes past 2048 packed rows and scenes over the TPU's
    SMEM budget (megakernel.py:166-206). Both thresholds were measured on
    the TPU, whose kernel keeps scene and texels in on-chip memory; a
    thread on the card reads both from global memory, so neither cliff is
    carried over."""
    if settings.sampler not in ("auto", "mega"):
        raise NotImplementedError(
            f"sampler={settings.sampler!r} is not ported yet: ROADMAP "
            "item 8")
    mean, segs = render_sample_mean_mega(scene, settings, o.T, d.T,
                                         frame_key, tile_offset=tile_offset)
    return mean.T, segs


def render_frame(scene, settings: RenderSettings, o: torch.Tensor,
                 d: torch.Tensor, accum: torch.Tensor, frame_num: int,
                 base_key: np.ndarray, tile_offset: int = 0):
    """One progressive frame: ``accum`` becomes the running mean of all
    frames so far, updated in place (src/raytracer.cu:109-113).
    Returns (accum, traced segment count)."""
    fkey = rng.frame_key(base_key, frame_num)
    mean, segs = render_sample_mean(scene, settings, o, d, fkey,
                                    tile_offset=tile_offset)
    return film.progressive_update(accum, mean, frame_num), segs
