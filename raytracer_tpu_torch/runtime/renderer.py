"""Frame-loop runtime: persistent device accumulator, stats,
checkpoint/resume.

Port of ``raytracer_tpu/runtime/renderer.py`` for one device, without
temporal mode. The accumulator lives on the render device and is updated
in place every frame; frames are enqueued without a host sync until a
caller asks for one (``block=True`` or ``render_frames``). A renderer on
``device="cuda"`` runs the CUDA kernels (the megakernel, or K5/K6 for the
wavefront samplers) and never moves to the CPU. The Renderer always takes
the kernel route; the plain versions and the oracles are reached only
through ``ops.integrator.render_sample_mean(backend=...)``.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from ..config import CameraConfig, RenderSettings
from ..models.camera import build_camera, morton_order, primary_rays
from ..ops import film, rng
from ..ops.integrator import render_frame, render_sample_mean
from ..ops.intersect_cuda import WaveScene
from ..ops.megakernel import MegaScene
from ..utils.image import save_png


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Renderer:
    """Progressive renderer with a persistent on-device accumulator."""

    def __init__(self, scene, camera: CameraConfig = CameraConfig(),
                 settings: RenderSettings = RenderSettings(), seed: int = 0,
                 device="cpu", sharding=None, adaptive_order: bool = False,
                 temporal: bool = False):
        if sharding is not None:
            raise NotImplementedError(
                "multi-device rendering is not ported yet: ROADMAP item 10")
        if temporal:
            raise NotImplementedError(
                "temporal mode is not ported yet: ROADMAP item 9")
        if adaptive_order:
            raise NotImplementedError(
                "adaptive pixel binning is not ported (measured "
                "net-negative on the TPU; ROADMAP 'not to be ported')")
        self.device = _device(device)
        if settings.pixpack is None:
            # auto policy (renderer.py:142-153): 8 pixels per lane at
            # spp <= 32, where a tile's retirement tail dominates
            settings = dataclasses.replace(
                settings, pixpack=8 if settings.rays_per_pixel <= 32 else 1)
        self.settings = settings
        self.scene = scene.to(self.device)
        # the scene packed once for the sampler that reads it
        mega = settings.sampler in ("auto", "mega")
        self._mega = MegaScene(self.scene) if mega else None
        self._wave = None if mega else WaveScene(self.scene)
        self.camera_cfg = camera
        # Morton order: consecutive rays cover compact screen blocks; a
        # ray's global pixel index keys its wavefront random streams
        self._pixel_order = morton_order(camera.width, camera.height)
        self._ray_idx = torch.as_tensor(self._pixel_order, device=self.device)
        self._o, self._d = primary_rays(
            build_camera(camera), camera.width, camera.height,
            pixel_order=self._pixel_order, device=self.device)

        self.frame_num = 0
        self.accum = film.new_accumulator(camera.num_pixels, self.device)
        self.base_key = rng.key(seed)
        self.total_segments = 0.0
        self.last_frame_ms = float("nan")
        self.stats_log: list = []

    @property
    def packed_scene(self):
        """The scene as the sampler reads it: a MegaScene or a WaveScene."""
        return self._wave if self._mega is None else self._mega

    # -- frame loop ----------------------------------------------------------
    def render_frame(self, block: bool = False) -> torch.Tensor:
        """Render one progressive frame; returns the (device) accumulator."""
        t0 = time.perf_counter()
        _, segs = render_frame(self.packed_scene, self.settings, self._o,
                               self._d, self.accum, self.frame_num,
                               self.base_key, ray_idx=self._ray_idx)
        if block:
            _sync(self.device)
        dt = time.perf_counter() - t0
        self.frame_num += 1
        if block:
            segs_f = float(segs)
            self.total_segments += segs_f
            self.last_frame_ms = dt * 1000.0
            self.stats_log.append(self.frame_stats(segs_f, dt))
        return self.accum

    def render_frames(self, n: int, fuse: bool = False) -> dict:
        """Render ``n`` progressive frames with a single final sync.

        ``fuse=True`` renders the n frames as one launch of
        n * rays_per_pixel samples under the first frame's key: the same
        running mean in expectation, with other sample streams."""
        t0 = time.perf_counter()
        if fuse and n > 1:
            batch = dataclasses.replace(
                self.settings,
                rays_per_pixel=self.settings.rays_per_pixel * n)
            fkey = rng.frame_key(self.base_key, self.frame_num)
            mean, segs = render_sample_mean(self.packed_scene, batch,
                                            self._o, self._d, fkey,
                                            ray_idx=self._ray_idx)
            fn = float(self.frame_num)
            self.accum.mul_(fn).add_(mean * float(n)).div_(fn + n)
            self.frame_num += n
            seg_handles = [segs]
        else:
            seg_handles = []
            for _ in range(n):
                _, segs = render_frame(self.packed_scene, self.settings,
                                       self._o, self._d, self.accum,
                                       self.frame_num, self.base_key,
                                       ray_idx=self._ray_idx)
                self.frame_num += 1
                seg_handles.append(segs)
        _sync(self.device)
        dt = time.perf_counter() - t0
        segments = float(sum(float(s) for s in seg_handles))
        self.total_segments += segments
        self.last_frame_ms = dt / n * 1000.0
        rec = self.frame_stats(segments, dt)
        rec["frames"] = n
        self.stats_log.append(rec)
        return rec

    def frame_stats(self, segments: float, seconds: float) -> dict:
        """Structured per-frame stats."""
        return {
            "frame": self.frame_num,
            "spp_total": self.frame_num * self.settings.rays_per_pixel,
            "frame_ms": seconds * 1000.0,
            "fps": 1.0 / seconds if seconds > 0 else float("inf"),
            "mrays_per_sec": segments / seconds / 1e6 if seconds > 0 else 0.0,
            "segments": segments,
            "device": str(self.device),
        }

    # -- output --------------------------------------------------------------
    def image(self) -> np.ndarray:
        """Current render as (H, W, 3) u8 in row-major pixel order."""
        flat = np.empty((self.camera_cfg.num_pixels, 3), np.float32)
        flat[self._pixel_order] = self.accum.cpu().numpy()  # undo Morton
        return film.to_u8(flat, self.camera_cfg.width,
                          self.camera_cfg.height, gamma=self.settings.gamma)

    def save_png(self, path: str) -> None:
        save_png(path, self.image())

    # -- checkpoint / resume --------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        np.savez(path, accum=self.accum.cpu().numpy(),
                 frame_num=self.frame_num,
                 key_data=rng.key_data(self.base_key),
                 total_segments=self.total_segments)

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint (same film size) onto this renderer's
        device; the next frame is bitwise what it would have been."""
        with np.load(path) as data:
            accum = torch.as_tensor(data["accum"], device=self.device)
            if accum.shape != self.accum.shape:
                raise ValueError(f"checkpoint accumulator {tuple(accum.shape)}"
                                 f" != {tuple(self.accum.shape)}")
            self.accum.copy_(accum)
            self.frame_num = int(data["frame_num"])
            self.base_key = rng.key_data(data["key_data"]).copy()
            self.total_segments = float(data["total_segments"])

    def write_stats(self, path: str) -> None:
        """JSONL stats sink."""
        with open(path, "a") as f:
            for rec in self.stats_log:
                f.write(json.dumps(rec) + "\n")
        self.stats_log.clear()

    def check_health(self) -> None:
        """Raise FloatingPointError if the accumulator holds NaN/Inf."""
        bad = int((~torch.isfinite(self.accum)).sum())
        if bad:
            raise FloatingPointError(
                f"non-finite values in progressive accumulator: "
                f"{bad}/{self.accum.numel()} elements")
