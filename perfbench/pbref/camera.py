"""Pinhole camera: the viewport basis, primary rays of chosen pixels and
the Morton pixel order (upstream src/camera.cu:46-108)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _rotation(axis: int, angle: float) -> np.ndarray:
    """The upstream matrix layout (src/matrix.cu:119-135): the X and Y
    rotations are the transpose of the usual convention."""
    s = np.float32(np.sin(angle))
    c = np.float32(np.cos(angle))
    if axis == 0:
        m = [[1, 0, 0], [0, c, s], [0, -s, c]]
    elif axis == 1:
        m = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    else:
        m = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    return np.array(m, dtype=np.float32)


def rotate_xyz(x: float, y: float, z: float) -> np.ndarray:
    return (_rotation(0, x) @ _rotation(1, y) @ _rotation(2, z)).astype(
        np.float32)


def basis(pose: dict, width: int, height: int):
    """(position, top-left pixel, step per pixel in x, in y), float32."""
    fov = pose.get("fov_deg", 60.0) * math.pi / 180.0
    focal = pose.get("focal_len", 0.1)
    vw = 2.0 * focal * np.tan(fov / 2.0)
    vh = vw / (width / height)
    rot = rotate_xyz(pose.get("x_rot", 0.0), pose.get("y_rot", 0.0),
                     pose.get("z_rot", 0.0))
    u = rot @ np.array([1.0, 0.0, 0.0], dtype=np.float32)
    v = rot @ np.array([0.0, -1.0, 0.0], dtype=np.float32)
    u = u / np.linalg.norm(u) * (vw / width)
    v = v / np.linalg.norm(v) * (vh / height)
    normal = np.cross(v, u)
    normal = normal / np.linalg.norm(normal)
    pos = np.array(pose["position"], dtype=np.float32)
    tl = (u * (-width / 2.0) + v * (-height / 2.0) + normal * focal
          + pos).astype(np.float32)
    return pos, tl, u.astype(np.float32), v.astype(np.float32)


def rays(pose: dict, width: int, height: int, pixels: torch.Tensor,
         dtype=torch.float32):
    """Primary rays of the row-major ``pixels``: origins and unit
    directions, each (n, 3)."""
    dev = pixels.device
    pos, tl, du, dv = (torch.as_tensor(a, device=dev)
                       for a in basis(pose, width, height))
    x = (pixels % width).to(torch.float32)[:, None]
    y = (pixels // width).to(torch.float32)[:, None]
    d = (tl + du * x + dv * y) - pos
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(dtype)
    o = pos.to(dtype).expand_as(d).contiguous()
    return o, d


def unit(d: torch.Tensor) -> torch.Tensor:
    """(3, n) directions times rsqrt of their squared length, the
    megakernel's normalisation of its input rays."""
    return d * torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])[None]


def morton_order(width: int, height: int) -> np.ndarray:
    """Row-major pixel indices sorted by Morton (Z-curve) code."""
    x, y = np.meshgrid(np.arange(width, dtype=np.uint64),
                       np.arange(height, dtype=np.uint64))

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    code = spread(x) | (spread(y) << np.uint64(1))
    return np.argsort(code.reshape(-1), kind="stable").astype(np.int64)
