"""Texture sampling for the wavefront samplers.

Port of ``raytracer_tpu/ops/textures.py``: all four texture types are
evaluated for every ray and selected per ray; an image texel comes from the
atlas with one index gather (the XLA gather of textures.py:49-60, not the
megakernel's image fetch K4).
"""

from __future__ import annotations

import torch

from ..models.materials import (TEX_CHECKERBOARD, TEX_COLOUR, TEX_GRADIENT,
                                TEX_IMAGE)
from .megakernel import _trunc_int
from .tables import MatCols


def sample_texture(scene, cols: MatCols, u: torch.Tensor, v: torch.Tensor,
                   base_colour: torch.Tensor) -> torch.Tensor:
    """Texture colour per ray -> (3, N) (textures.py:22-61).
    ``base_colour`` is the winning primitive's const colour (3, N).
    Float-to-int casts truncate, saturate and send NaN to 0, as XLA's."""
    ttype = cols.tex_type

    # checkerboard (src/material.cu:90-99): truncating casts, parity
    u_c = _trunc_int(u * cols.tex_nsq)
    v_c = _trunc_int(v * cols.tex_nsq)
    is_light = ((u_c + v_c) % 2) == 0
    checker = torch.where(is_light[None, :], cols.tex_light, cols.tex_dark)

    # gradient (src/material.cu:80-82): colour = (u, v, 0)
    gradient = torch.stack([u, v, torch.zeros_like(u)])

    out = torch.where((ttype == TEX_COLOUR)[None, :], base_colour, 0.0)
    out = torch.where((ttype == TEX_GRADIENT)[None, :], gradient, out)
    out = torch.where((ttype == TEX_CHECKERBOARD)[None, :], checker, out)

    # image: nearest texel of the atlas (src/material.cu:119-124); an atlas
    # of one texel means the scene has no image texture
    if scene.atlas.shape[0] > 1:
        w, h = cols.tex_w, cols.tex_h
        u_i = torch.clamp(_trunc_int((w - 1).to(torch.float32) * u),
                          min=torch.zeros_like(w), max=w - 1)
        v_i = torch.clamp(_trunc_int((h - 1).to(torch.float32) * v),
                          min=torch.zeros_like(h), max=h - 1)
        flat = torch.clamp(cols.tex_off + v_i * w + u_i, 0,
                           scene.atlas.shape[0] - 1)
        image = scene.atlas.T[:, flat.long()]
        out = torch.where((ttype == TEX_IMAGE)[None, :], image, out)
    return out
