"""Material-table lookup for the wavefront samplers.

Port of ``raytracer_tpu/ops/tables.py``. The JAX package fetches all
material columns with one one-hot matmul because per-element gathers are
slow on the TPU; the matmul of a one-hot column is exact, so a plain index
gather gives the same values, and on the card a gather is the cheap form.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MatCols:
    """Per-ray material behaviour parameters (lanes = rays). Colour and
    smoothness live on the primitives (ShadeData); the refractive index is
    the medium's, shared by every primitive of the material."""

    mat_type: torch.Tensor    # (N,) i32
    ior: torch.Tensor         # (N,) f32
    emit: torch.Tensor        # (3, N) f32
    tex_type: torch.Tensor    # (N,) i32
    tex_light: torch.Tensor   # (3, N) f32
    tex_dark: torch.Tensor    # (3, N) f32
    tex_nsq: torch.Tensor     # (N,) f32
    tex_off: torch.Tensor     # (N,) i32
    tex_w: torch.Tensor       # (N,) i32
    tex_h: torch.Tensor       # (N,) i32


def lookup_material(scene, mat_id: torch.Tensor) -> MatCols:
    """All material columns for (N,) material ids (tables.py:42-85)."""
    m = mat_id.long()
    return MatCols(
        mat_type=scene.mat_type[m],
        ior=scene.mat_ior[m],
        emit=scene.mat_emit.T[:, m],
        tex_type=scene.tex_type[m],
        tex_light=scene.tex_light.T[:, m],
        tex_dark=scene.tex_dark.T[:, m],
        tex_nsq=scene.tex_nsq[m],
        tex_off=scene.tex_offset[m],
        tex_w=scene.tex_width[m],
        tex_h=scene.tex_height[m],
    )
