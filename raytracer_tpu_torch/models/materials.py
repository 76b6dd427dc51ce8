"""Host-side texture and material builders (numpy).

Plain dataclasses used while building a scene; ``compile_materials``
flattens them into a structure-of-arrays material table plus one texel
atlas of every distinct image (reference: src/material.cu:4-186).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Texture type tags (reference: src/material.cu:7-10).
TEX_COLOUR = 0
TEX_GRADIENT = 1
TEX_CHECKERBOARD = 2
TEX_IMAGE = 3

# Material type tags (reference: src/material.cu:131-133).
MAT_STANDARD = 0
MAT_EMISSIVE = 1
MAT_REFRACTIVE = 2


@dataclasses.dataclass(frozen=True)
class Texture:
    """Texture description (reference: src/material.cu:4-125)."""

    type: int = TEX_COLOUR
    colour: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    light: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dark: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    num_squares: int = 0
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0, 1]

    @staticmethod
    def const_colour(colour) -> "Texture":
        return Texture(type=TEX_COLOUR, colour=tuple(float(c) for c in colour))

    @staticmethod
    def gradient() -> "Texture":
        """uv-visualising gradient (src/material.cu:80-82): colour = (u, v, 0)."""
        return Texture(type=TEX_GRADIENT)

    @staticmethod
    def checkerboard(light, dark, num_squares: int) -> "Texture":
        return Texture(
            type=TEX_CHECKERBOARD,
            light=tuple(float(c) for c in light),
            dark=tuple(float(c) for c in dark),
            num_squares=int(num_squares),
        )

    @staticmethod
    def from_image(image: np.ndarray) -> "Texture":
        img = np.asarray(image, dtype=np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"image texture must be (H, W, 3), got "
                             f"{img.shape}")
        return Texture(type=TEX_IMAGE, image=img)

    def __hash__(self):  # image arrays are compared by identity
        return hash((self.type, self.colour, self.light, self.dark,
                     self.num_squares, id(self.image)))


@dataclasses.dataclass(frozen=True)
class Material:
    """Material description (reference: src/material.cu:128-186)."""

    type: int = MAT_STANDARD
    texture: Texture = Texture()
    smoothness: float = 0.0  # [0, 1]; 0 = diffuse, 1 = mirror
    emitted_light: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    refractive_index: float = 1.0

    @staticmethod
    def standard(texture: Texture, smoothness: float) -> "Material":
        return Material(type=MAT_STANDARD, texture=texture,
                        smoothness=float(smoothness))

    @staticmethod
    def emissive(colour, strength: float,
                 smoothness: float = 0.0) -> "Material":
        # Colour and strength are pre-combined (src/material.cu:170); the
        # reference leaves smoothness uninitialised, we default it to 0.
        emitted = tuple(float(c) * float(strength) for c in colour)
        return Material(type=MAT_EMISSIVE, emitted_light=emitted,
                        smoothness=float(smoothness))

    @staticmethod
    def refractive(texture: Texture, refractive_index: float) -> "Material":
        # Smoothness forced to 1 so Fresnel reflections are mirror-like
        # (src/material.cu:182).
        return Material(type=MAT_REFRACTIVE, texture=texture,
                        smoothness=1.0, refractive_index=float(refractive_index))

    @staticmethod
    def default() -> "Material":
        """Defined stand-in for the reference's uninitialised default
        ``Material()`` (src/main.cu:223-237): white diffuse."""
        return Material.standard(Texture.const_colour((1.0, 1.0, 1.0)), 0.0)


@dataclasses.dataclass
class MaterialTable:
    """Flattened numpy material table (host side)."""

    mat_type: np.ndarray      # (M,) int32
    smoothness: np.ndarray    # (M,) float32
    ior: np.ndarray           # (M,) float32
    emitted: np.ndarray       # (M, 3) float32
    tex_type: np.ndarray      # (M,) int32
    tex_colour: np.ndarray    # (M, 3) float32
    tex_light: np.ndarray     # (M, 3) float32
    tex_dark: np.ndarray      # (M, 3) float32
    tex_nsq: np.ndarray       # (M,) float32
    tex_offset: np.ndarray    # (M,) int32 index into atlas (0: no image)
    tex_width: np.ndarray     # (M,) int32
    tex_height: np.ndarray    # (M,) int32
    atlas: np.ndarray         # (P, 3) float32 texels; slot 0 is a dummy


def compile_materials(materials: List[Material]) -> MaterialTable:
    """Flatten material builders into the SoA table, one row each. Each
    distinct image (by identity) is appended to the atlas once."""
    m = len(materials)
    table = MaterialTable(
        mat_type=np.zeros(m, np.int32),
        smoothness=np.zeros(m, np.float32),
        ior=np.ones(m, np.float32),
        emitted=np.zeros((m, 3), np.float32),
        tex_type=np.zeros(m, np.int32),
        tex_colour=np.zeros((m, 3), np.float32),
        tex_light=np.zeros((m, 3), np.float32),
        tex_dark=np.zeros((m, 3), np.float32),
        tex_nsq=np.zeros(m, np.float32),
        tex_offset=np.zeros(m, np.int32),
        tex_width=np.ones(m, np.int32),
        tex_height=np.ones(m, np.int32),
        atlas=np.zeros((1, 3), np.float32),
    )
    atlas_parts = [np.zeros((1, 3), np.float32)]  # slot 0: dummy texel
    offset = 1
    image_cache: dict = {}
    for i, mat in enumerate(materials):
        tex = mat.texture
        table.mat_type[i] = mat.type
        table.smoothness[i] = mat.smoothness
        table.ior[i] = mat.refractive_index
        table.emitted[i] = mat.emitted_light
        table.tex_type[i] = tex.type
        table.tex_colour[i] = tex.colour
        table.tex_light[i] = tex.light
        table.tex_dark[i] = tex.dark
        table.tex_nsq[i] = float(tex.num_squares)
        if tex.type == TEX_IMAGE:
            key = id(tex.image)
            if key not in image_cache:
                h, w, _ = tex.image.shape
                atlas_parts.append(tex.image.reshape(-1, 3).astype(np.float32))
                image_cache[key] = (offset, w, h)
                offset += h * w
            off, w, h = image_cache[key]
            table.tex_offset[i] = off
            table.tex_width[i] = w
            table.tex_height[i] = h
    # Texels are quantised to 10 bits per channel (H5), the colour30 values
    # that the texel plane of the megakernel packs into one int32, so the
    # in-kernel fetch and the atlas gather decode the same floats.
    atlas = np.concatenate(atlas_parts, axis=0)
    q = np.round(np.clip(atlas, 0.0, 1.0) * 1023.0).astype(np.float32)
    table.atlas = q * np.float32(1.0 / 1023.0)
    return table
