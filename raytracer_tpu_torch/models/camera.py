"""Camera model: pixel grid -> world-space primary rays.

The host computes the viewport basis once (src/camera.cu:46-60); primary
rays are then one tensor expression over the whole pixel grid
(src/camera.cu:24-29, src/ray.cu:147-155).

``camera_rays`` builds the temporal frame's megakernel input from the
basis in one CUDA kernel, ``rt_camera_rays`` (csrc/camera.cu): the
scanline primary rays, padded to whole tiles and normalised again, as
JAX builds them inside its temporal step (raytracer_tpu/runtime/
renderer.py:355-362). ``camera_rays_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CameraConfig
from ..kernels import build
from ..ops.megakernel import MEGA_TILE, PaddedRays, pad_rays
from ..utils import matrix as hm
from ..utils.device import resolve_device


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
                 pixel_order: Optional[np.ndarray] = None, device="cuda"):
    """Primary rays for every pixel: ``(origins, directions)``, each
    ``(H*W, 3)`` float32 on ``device`` (src/ray.cu:147-155).

    ``pixel_order`` permutes the flattened row-major pixel index (e.g. the
    Morton order, so consecutive rays cover compact screen regions).
    ``device`` defaults to the card and raises without one
    (utils/device.py).
    """
    device = resolve_device(device)
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


def camera_rays_reference(cam: CameraArrays, width: int, height: int,
                          pixpack: int, device="cuda") -> PaddedRays:
    """Plain version of ``rt_camera_rays``: ``pad_rays`` over the
    scanline ``primary_rays`` (raytracer_tpu/ops/megakernel.py:1189-1202
    over raytracer_tpu/models/camera.py:83-107)."""
    o, d = primary_rays(cam, width, height, device=device)
    o_p, d_p = pad_rays(o.T, d.T, pixpack)
    return PaddedRays(o_p, d_p, width * height, pixpack)


def camera_rays(cam: CameraArrays, width: int, height: int, pixpack: int,
                device="cuda") -> PaddedRays:
    """The megakernel's input for the scanline primary rays of ``cam``:
    (3, n_pad) origins and unit directions, n_pad whole tiles of
    4096 * ``pixpack`` lanes, pad lanes o = 0 and d = (1, 0, 0), every
    direction normalised twice as ``camera_rays_reference`` does. On the
    CPU the plain version; on the card one launch of ``rt_camera_rays``
    (or an error)."""
    device = resolve_device(device)
    if pixpack < 1 or width < 1 or height < 1:
        raise ValueError(f"bad film {width}x{height} or pixpack {pixpack}")
    if device.type == "cpu":
        return camera_rays_reference(cam, width, height, pixpack, device)
    if device.type != "cuda":
        raise ValueError(f"no camera rays for device {device}")
    n = width * height
    tile = MEGA_TILE * pixpack
    n_pad = max(tile, -(-n // tile) * tile)
    o = torch.empty((3, n_pad), dtype=torch.float32, device=device)
    d = torch.empty((3, n_pad), dtype=torch.float32, device=device)
    build.launch("rt_camera_rays", _camera_args(cam, o, d, n, width),
                 device)
    return PaddedRays(o, d, n, pixpack)


def _camera_args(cam: CameraArrays, o: torch.Tensor, d: torch.Tensor,
                n: int, width: int):
    """rt_camera_rays' arguments over (3, n_pad) contiguous CUDA outputs
    (the caller keeps them alive across the launch)."""
    return build.CameraRaysArgs(
        o=o.data_ptr(), d=d.data_ptr(), pos=f3(cam.position),
        tl=f3(cam.tl_pixel), du=f3(cam.delta_u), dv=f3(cam.delta_v), n=n,
        n_pad=o.shape[1], width=width)


def f3(v):
    """A float32 3-vector as a ctypes float[3]."""
    return (ctypes.c_float * 3)(*[float(c) for c in np.asarray(
        v, np.float32)])


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
