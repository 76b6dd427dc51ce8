"""Frame-loop runtime: persistent device accumulator, stats,
checkpoint/resume, camera moves and the temporal fly-through.

Port of ``raytracer_tpu/runtime/renderer.py``. The accumulator lives on
the render device and is updated in place every frame; frames are
enqueued without a host sync until a caller asks for one (``block=True``
or ``render_frames``). A renderer runs on the card
(``device="cuda"``, the default) unless the caller asks for the CPU; on
the card it runs the CUDA kernels (the megakernel; ``rt_wave_rays``,
K5/K6 and ``rt_wave_bounce`` for the wavefront samplers, replayed as CUDA
graphs that ``packed_scene`` caches; in temporal mode the camera rays,
the megakernel and the temporal frame's epilogue) and never moves to the
CPU. The Renderer always takes the kernel route; the plain
versions and the oracles are reached only through
``ops.integrator.render_sample_mean(backend=...)`` and the ``*_reference``
functions.

Temporal mode (``temporal=True``, renderer.py:163-222 and 344-455):
per-pixel accumulation weights instead of the frame counter, scanline
pixel order, the megakernel whatever ``settings.sampler`` says (its
primary-hit depth drives the reprojection), and ``move_camera`` warps the
accumulated image into the new view instead of restarting it. The JAX
package serves it only on a TPU; this port serves it on any device. As in
JAX's temporal step, a frame is three launches on the card: the padded
primary rays, built from the camera basis at the first frame of a camera
(``camera_rays``; renderer.py:355-362), the megakernel, and the epilogue
(``warp.temporal_frame``: the blend, and after a move the history gather
before it, and the frame's segment count; :365-391).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import CameraConfig, RenderSettings
from ..models.camera import (build_camera, camera_rays, morton_order,
                             primary_rays)
from ..ops import film, rng, warp
from ..ops.integrator import render_frame, render_sample_mean
from ..ops.intersect_cuda import WaveScene
from ..ops.megakernel import MegaScene, mega_frame
from ..parallel.distributed import gather_image, local_device
from ..utils.debug import check_finite
from ..utils.device import resolve_device
from ..utils.image import save_png
from ..utils.trace import span


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Renderer:
    """Progressive renderer with a persistent on-device accumulator."""

    def __init__(self, scene, camera: CameraConfig = CameraConfig(),
                 settings: RenderSettings = RenderSettings(), seed: int = 0,
                 device="cuda", sharding=None, shard_mode: str = "pixel",
                 adaptive_order: bool = False, temporal: bool = False):
        if sharding is not None:
            if temporal:
                raise ValueError(
                    "temporal mode renders on one device; it has no "
                    "sharded step (ROADMAP item 10's parity note)")
            device = local_device(device)
        if adaptive_order:
            raise NotImplementedError(
                "adaptive pixel binning is not ported (measured "
                "net-negative on the TPU; ROADMAP 'not to be ported')")
        self.device = resolve_device(device)
        if settings.pixpack is None:
            # auto policy (renderer.py:142-153): 8 pixels per lane at
            # spp <= 32, where a tile's retirement tail dominates
            settings = dataclasses.replace(
                settings, pixpack=8 if settings.rays_per_pixel <= 32 else 1)
        self.settings = settings
        self.scene = scene.to(self.device)
        # the scene packed once for the sampler that reads it; the temporal
        # step renders through the megakernel whatever the sampler
        # (renderer.py:363, 379)
        self._temporal = bool(temporal)
        mega = self._temporal or settings.sampler in ("auto", "mega")
        self._mega = MegaScene(self.scene) if mega else None
        self._wave = None if mega else WaveScene(self.scene)
        # Morton order: consecutive rays cover compact screen blocks; a
        # ray's global pixel index keys its wavefront random streams.
        # Temporal mode takes scanline (identity) order, the JAX default
        # there (renderer.py:169-184): the order decides which random
        # stream a pixel sees, and the history plane is in pixel order.
        n = camera.num_pixels
        self._pixel_order = (np.arange(n, dtype=np.int32) if self._temporal
                             else morton_order(camera.width, camera.height))
        self._sharding = sharding
        self._shard_step, self._rows, self._placement = (
            self._sharded_step(sharding, shard_mode, n)
            if sharding is not None else (None, slice(None), None))
        self._n_local = len(range(n)[self._rows])
        self._ray_idx = torch.as_tensor(self._pixel_order[self._rows],
                                        device=self.device)
        self._set_rays(camera)

        self.frame_num = 0
        self.accum = film.new_accumulator(self._n_local, self.device)
        self.base_key = rng.key(seed)
        self.total_segments = 0.0
        self.stats_log: list = []
        self._last_segs = None  # device scalar of the last frame

        # temporal state (renderer.py:216-222): per-pixel weights, the last
        # frame's primary-hit depth, the pending warp source and the
        # monotonic RNG frame counter (never reset; frame keys come from it,
        # not from frame_num)
        self._wpix = (torch.zeros(n, dtype=torch.float32, device=self.device)
                      if self._temporal else None)
        self._depth = None
        self._warp_src = None
        self._rng_frame = 0
        self._zeros = None  # the film shown between a move and its frame

    def _sharded_step(self, sharding, shard_mode: str, n: int):
        """(step, this rank's pixel rows, the film's placement) of a
        sharded renderer (renderer.py:224-255)."""
        from ..parallel import shard
        from ..parallel.mesh import (PIXEL_AXIS, SPP_AXIS, check_device,
                                     pixel_sharding, replicated)
        mesh = sharding.mesh
        if shard_mode not in ("pixel", "spp", "hybrid"):
            raise ValueError(f"unknown shard_mode {shard_mode!r}; use "
                             "'pixel', 'spp' or 'hybrid'")
        if shard_mode == "hybrid" and SPP_AXIS not in mesh.axis_names:
            raise ValueError("shard_mode='hybrid' needs a 2D (px, spp) mesh"
                             " — build it with parallel.mesh.make_mesh_2d")
        check_device(mesh, self.device)
        if shard_mode == "spp":
            return (shard.make_spp_sharded_step(mesh, self.settings),
                    slice(None), replicated(mesh))
        make = (shard.make_pixel_sharded_step if shard_mode == "pixel"
                else shard.make_hybrid_sharded_step)
        rows = shard.shard_rows(n, mesh.axis_index(PIXEL_AXIS),
                                mesh.axis_size(PIXEL_AXIS))
        return make(mesh, self.settings), rows, pixel_sharding(mesh)

    def _set_rays(self, camera: CameraConfig) -> None:
        self.camera_cfg = camera
        if self._temporal:
            # the temporal step builds its padded rays from the basis at
            # the camera's first frame (renderer.py:355-362), so moves
            # between two frames build nothing
            self._cam = build_camera(camera)
            self._rays = None
            return
        # a pixel shard builds its own slice's rays
        self._o, self._d = primary_rays(
            build_camera(camera), camera.width, camera.height,
            pixel_order=self._pixel_order[self._rows], device=self.device)

    @property
    def packed_scene(self):
        """The scene as the sampler reads it: a MegaScene or a WaveScene."""
        return self._wave if self._mega is None else self._mega

    # -- camera -------------------------------------------------------------
    def set_camera(self, camera: CameraConfig) -> None:
        """Move the camera and restart progressive accumulation
        (renderer.py:289-303). The film size stays fixed."""
        if (camera.width, camera.height) != (self.camera_cfg.width,
                                             self.camera_cfg.height):
            raise ValueError("set_camera keeps the film size; build a new "
                             "Renderer to resize")
        self._set_rays(camera)
        self.accum = film.new_accumulator(self._n_local, self.device)
        if self._wpix is not None:
            self._wpix = torch.zeros_like(self._wpix)
        self._depth = None
        self.frame_num = 0

    def move_camera(self, camera: CameraConfig, reproject: bool = True,
                    history: float = 8.0) -> None:
        """Camera move with temporal reprojection (renderer.py:410-455).

        The warp is deferred and inverse: the old accumulation, weights,
        history cap and camera basis are stashed, and the next rendered
        frame gathers history into the new view per pixel from its own
        primary-hit depth (ops/warp.py). History weight is capped at
        ``history`` frames; disoccluded or out-of-view pixels restart.
        Repeated moves before the next frame keep warping from the last
        *rendered* view. Falls back to ``set_camera`` when not temporal,
        when nothing has been rendered yet, with ``reproject=False`` or
        when the film size changes (which ``set_camera`` refuses)."""
        rendered = (self._wpix is not None
                    and (self.frame_num > 0 or self._warp_src is not None))
        if not (self._temporal and reproject and rendered
                and (camera.width, camera.height) == (self.camera_cfg.width,
                                                      self.camera_cfg.height)):
            self._depth = None
            self._warp_src = None
            self.set_camera(camera)
            return
        if self._warp_src is None:
            self._warp_src = warp.history_source(self.accum, self._wpix,
                                                 history, self._cam)
            self.accum, self._wpix = self._zero_film()
        self._depth = None
        self._set_rays(camera)
        self.frame_num = 0

    def _zero_film(self):
        """The zero accumulation and weights shown between a move and the
        next frame, made once: that frame writes new planes and never
        these, so a move fills nothing."""
        if self._zeros is None:
            n = self.camera_cfg.num_pixels
            self._zeros = (film.new_accumulator(n, self.device),
                           torch.zeros(n, dtype=torch.float32,
                                       device=self.device))
        return self._zeros

    def _temporal_render(self) -> torch.Tensor:
        """One temporal frame (renderer.py:344-408): the padded rays at a
        camera's first frame, the megakernel with depth, then the epilogue:
        the per-pixel-weight blend, after a move over the stashed
        accumulation gathered into this view as JAX packs and gathers it."""
        with span("frame.key"):
            fkey = rng.frame_key(self.base_key, self._rng_frame)
        self._rng_frame += 1
        cam = self.camera_cfg
        if self._rays is None:
            with span("temporal.rays"):
                self._rays = camera_rays(self._cam, cam.width, cam.height,
                                         self.settings.pixpack, self.device)
        out, n = mega_frame(self._mega, self.settings, self._rays, None,
                            fkey)
        with span("temporal.epilogue"):
            self.accum, self._wpix, segs = warp.temporal_frame(
                out, n, self.accum, self._wpix, self._warp_src, self._cam,
                cam.width, cam.height)
        self._warp_src = None
        self._depth = out[4, :n]
        return segs

    def _step(self) -> torch.Tensor:
        """One frame of either mode, as span ``frame``; returns its
        segment count."""
        with span("frame", self.frame_num):
            if self._temporal:
                segs = self._temporal_render()
            elif self._shard_step is not None:
                self.accum, segs = self._shard_step(
                    self.packed_scene, self._ray_idx, self._o, self._d,
                    self.accum, self.frame_num, self.base_key)
            else:
                _, segs = render_frame(self.packed_scene, self.settings,
                                       self._o, self._d, self.accum,
                                       self.frame_num, self.base_key,
                                       ray_idx=self._ray_idx)
        self._last_segs = segs
        return segs

    # -- frame loop ----------------------------------------------------------
    def render_frame(self, block: bool = False) -> torch.Tensor:
        """Render one progressive frame; returns the (device) accumulator."""
        t0 = time.perf_counter()
        segs = self._step()
        if block:
            with span("frame.sync", self.frame_num):
                _sync(self.device)
                dt = time.perf_counter() - t0
                segs_f = float(segs)
        self.frame_num += 1
        if block:
            self.total_segments += segs_f
            self.stats_log.append(self.frame_stats(segs_f, dt))
        return self.accum

    def render_frames(self, n: int, fuse: bool = False) -> dict:
        """Render ``n`` progressive frames with a single final sync.

        ``fuse=True`` renders the n frames as one launch of
        n * rays_per_pixel samples under the first frame's key: the same
        running mean in expectation, with other sample streams. Temporal
        mode never fuses and runs its own step per frame (ROADMAP F5: the
        JAX package's sequential loop runs the non-temporal step there);
        a sharded renderer never fuses (renderer.py:499)."""
        t0 = time.perf_counter()
        if (fuse and n > 1 and not self._temporal
                and self._sharding is None):
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
                seg_handles.append(self._step())
                self.frame_num += 1
        with span("frame.sync", self.frame_num - 1):
            _sync(self.device)
            dt = time.perf_counter() - t0
            segments = float(sum(float(s) for s in seg_handles))
        self.total_segments += segments
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
    def _writes(self) -> bool:
        """Whether this process writes the files: rank 0 of a mesh."""
        return self._sharding is None or self._sharding.mesh.rank == 0

    def _barrier(self) -> None:
        if self._sharding is not None:
            dist.barrier(group=self._sharding.mesh.group)

    def image(self) -> np.ndarray:
        """Current render as (H, W, 3) u8 in row-major pixel order. Under
        sharding every rank gathers the whole film (and must call it)."""
        with span("image.copy"):
            host = gather_image(self.accum, self._placement)
        with span("image.to_u8"):
            flat = np.empty((self.camera_cfg.num_pixels, 3), np.float32)
            flat[self._pixel_order] = host   # undo Morton
            return film.to_u8(flat, self.camera_cfg.width,
                              self.camera_cfg.height,
                              gamma=self.settings.gamma)

    def save_png(self, path: str) -> None:
        img = self.image()
        if self._writes():
            save_png(path, img)
        self._barrier()

    # -- checkpoint / resume --------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Write the whole accumulator; under sharding every rank must call
        it, rank 0 writes and the others wait until the file is there."""
        accum = gather_image(self.accum, self._placement)
        if self._writes():
            np.savez(path, accum=accum, frame_num=self.frame_num,
                     key_data=rng.key_data(self.base_key),
                     total_segments=self.total_segments)
        self._barrier()

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint (same film size, written by any topology)
        onto this renderer's device and placement; the next frame is
        bitwise what it would have been (renderer.py:597-617)."""
        with np.load(path) as data:
            accum = data["accum"]
            want = (self.camera_cfg.num_pixels, 3)
            if accum.shape != want:
                raise ValueError(f"checkpoint accumulator {accum.shape} != "
                                 f"{want}")
            if self._zeros is not None and self.accum is self._zeros[0]:
                self.accum = self.accum.clone()   # the zero film stays zero
            self.accum.copy_(torch.as_tensor(accum[self._rows],
                                             device=self.device))
            self.frame_num = int(data["frame_num"])
            self.base_key = rng.key_data(data["key_data"]).copy()
            self.total_segments = float(data["total_segments"])

    def write_stats(self, path: str) -> None:
        """JSONL stats sink."""
        with open(path, "a") as f:
            for rec in self.stats_log:
                f.write(json.dumps(rec) + "\n")
        self.stats_log.clear()

    # -- profiling -----------------------------------------------------------
    def profile_frame(self, trace_dir: str) -> str:
        """Profile one blocking frame (renderer.py:627-632) under
        torch.profiler: CPU activity, and the card's kernels when the
        renderer is on one. Writes a Chrome trace (chrome://tracing,
        Perfetto) into ``trace_dir``, which it creates, and returns its
        path; each rank of a mesh writes its own file."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        rank = 0 if self._sharding is None else self._sharding.mesh.rank
        path = os.path.join(trace_dir, f"frame{self.frame_num}_rank{rank}"
                                       ".trace.json")
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            self.render_frame(block=True)
        prof.export_chrome_trace(path)
        return path

    def check_health(self) -> None:
        """Raise FloatingPointError if the accumulator holds NaN/Inf: one
        reduction, one bool to the host. Under sharding every rank must
        call it, and every rank raises if any rank's piece is poisoned."""
        ok = torch.isfinite(self.accum).all().to(torch.int32)
        if self._sharding is not None:
            dist.all_reduce(ok, op=dist.ReduceOp.MIN,
                            group=self._sharding.mesh.group)
        if not bool(ok):
            check_finite(self.accum, "progressive accumulator")
            raise FloatingPointError("non-finite values in another rank's "
                                     "piece of the progressive accumulator")
