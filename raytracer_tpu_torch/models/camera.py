"""Camera model: pixel grid -> world-space primary rays.

The host computes the viewport basis once (src/camera.cu:46-60); primary
rays are then one tensor expression over the whole pixel grid
(src/camera.cu:24-29, src/ray.cu:147-155).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CameraConfig
from ..utils import matrix as hm


@dataclasses.dataclass(frozen=True)
class CameraArrays:
    """Viewport basis, float32 numpy (src/camera.cu:12-18)."""

    position: np.ndarray  # (3,)
    tl_pixel: np.ndarray  # (3,) world position of pixel (0, 0)
    delta_u: np.ndarray   # (3,) world step per pixel in +x
    delta_v: np.ndarray   # (3,) world step per pixel in +y (screen down)


def build_camera(cfg: CameraConfig) -> CameraArrays:
    """Compute the viewport basis (src/camera.cu:46-108)."""
    viewport_width = 2.0 * cfg.focal_len * np.tan(cfg.fov_rad / 2.0)
    viewport_height = viewport_width / cfg.aspect

    rot = hm.rotate_xyz(cfg.x_rot, cfg.y_rot, cfg.z_rot)

    # u points along the top of the screen, v down its left edge
    u = rot @ np.array([1.0, 0.0, 0.0], dtype=np.float32)
    v = rot @ np.array([0.0, -1.0, 0.0], dtype=np.float32)

    u = u / np.linalg.norm(u) * (viewport_width / cfg.width)
    v = v / np.linalg.norm(v) * (viewport_height / cfg.height)

    # plane normal points away from the camera (src/camera.cu:53)
    normal = np.cross(v, u)
    normal = normal / np.linalg.norm(normal)

    pos = np.array(cfg.position, dtype=np.float32)
    tl = (
        u * (-cfg.width / 2.0)
        + v * (-cfg.height / 2.0)
        + normal * cfg.focal_len
        + pos
    ).astype(np.float32)

    return CameraArrays(position=pos, tl_pixel=tl,
                        delta_u=u.astype(np.float32),
                        delta_v=v.astype(np.float32))


def pixel_to_world(cam: CameraArrays, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> (..., 3) point on the screen plane
    (src/camera.cu:24-29)."""
    dev = x.device
    tl = torch.as_tensor(cam.tl_pixel, device=dev)
    du = torch.as_tensor(cam.delta_u, device=dev)
    dv = torch.as_tensor(cam.delta_v, device=dev)
    xf = x.to(torch.float32)[..., None]
    yf = y.to(torch.float32)[..., None]
    return tl + du * xf + dv * yf


def primary_rays(cam: CameraArrays, width: int, height: int,
                 pixel_order: Optional[np.ndarray] = None, device="cpu"):
    """Primary rays for every pixel: ``(origins, directions)``, each
    ``(H*W, 3)`` float32 on ``device`` (src/ray.cu:147-155).

    ``pixel_order`` permutes the flattened row-major pixel index (e.g. the
    Morton order, so consecutive rays cover compact screen regions).
    """
    if pixel_order is None:
        idx = torch.arange(width * height, dtype=torch.int32, device=device)
    else:
        idx = torch.as_tensor(np.asarray(pixel_order, np.int32),
                              device=device)
    x = idx % width
    y = idx // width
    view = pixel_to_world(cam, x, y)
    d = view - torch.as_tensor(cam.position, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(cam.position, device=device).expand_as(d)
    return o.contiguous(), d


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
    return np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
