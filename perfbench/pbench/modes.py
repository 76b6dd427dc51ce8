"""The cells' drivers: the program's own loops, run through a measured
window.

``progressive``: ``Renderer.render_frame(block=True)`` back to back, as
the CLI's render loop runs it (runtime/viewer.py ``run_render_loop``).
The loop is closed: a frame starts when the previous one has returned.
Set-up builds the scene and the renderer and renders ``warmup_frames``
frames, so every kernel is built, every graph captured and every shape
the window uses warmed before the window opens. A traced window runs
under torch.profiler and marks its opening and each frame's end with
the marker kernel of ``pbench.profile``.

What the program is given is data: the configuration's ``program``
names the port's scene function (``call``, a dotted name inside the
port's package, with ``args`` and ``kwargs``; it returns the scene and
whether it has a sky), and ``spec.render_settings`` gathers the
``RenderSettings`` fields by name. A mode, a scene function's result or
a settings field that the harness does not know raises before any frame.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import torch

from pbref import render

from . import profile, spec


@dataclasses.dataclass
class Window:
    """What a measured window recorded."""

    setup_s: float = 0.0
    window_s: float = 0.0
    frame_s: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    phases: list = dataclasses.field(default_factory=list)
    trace: object = None
    memory_peak: int = 0
    checked: dict = dataclasses.field(default_factory=dict)
    recording: bool = False

    @property
    def frames(self) -> int:
        return len(self.frame_s)

    @contextlib.contextmanager
    def span(self, name: str, keep_phase: bool):
        """Time the block as span ``name`` while the window records."""
        if not self.recording:
            yield
            return
        t = time.perf_counter()
        yield
        e = time.perf_counter()
        self.spans.setdefault(name, []).append(e - t)
        if keep_phase:
            self.phases.append((name, t, e))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_scene(cell, dev):
    """The configuration's scene as the program builds it, and its sky."""
    prog = cell.config["program"]
    module, _, name = prog["call"].rpartition(".")
    if module.split(".")[0] != "raytracer_tpu_torch":
        raise ValueError(f"{prog['call']!r} is not the port's")
    build = getattr(importlib.import_module(module), name)
    out = build(*prog.get("args", []), device=dev, **prog.get("kwargs", {}))
    if not (isinstance(out, tuple) and len(out) == 2
            and isinstance(out[1], bool)):
        raise TypeError(f"{prog['call']} returned {type(out).__name__}, "
                        "not (scene, use_sky): the harness knows no other "
                        "form")
    return out


def settings_of(cell, use_sky: bool):
    from raytracer_tpu_torch.config import RenderSettings
    return RenderSettings(**spec.render_settings(cell)).with_sky(use_sky)


def camera_of(cell, pose: dict):
    from raytracer_tpu_torch.config import CameraConfig
    t = cell.traffic
    return CameraConfig(
        width=t["width"], height=t["height"],
        position=tuple(pose["position"]), fov_deg=pose["fov_deg"],
        focal_len=pose["focal_len"], x_rot=pose["x_rot"],
        y_rot=pose["y_rot"], z_rot=pose["z_rot"])


def check_lanes(cell, seed: int, dev):
    """The lane slots the check samples, drawn from the seed, and their
    pixel count a lane."""
    t = cell.traffic
    k = render.pixpack(t["spp"])
    tiles, slots = render.choose_lanes(seed, t["width"] * t["height"], k,
                                       cell.check["lanes"], dev)
    return tiles, slots, k


def _measure(win: Window, dev, seconds: float, trace_s: float,
             frame) -> None:
    """Run ``frame()`` back to back for ``seconds``; record each frame's
    wall time and, with ``trace_s`` > 0, the profiler's trace of the
    window's first ``trace_s`` seconds (whole frames)."""
    prof = None
    if trace_s > 0:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
    _sync(dev)
    win.recording = True
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    tracing = prof is not None
    launches = []
    if tracing:
        with torch.profiler.record_function(profile.ALIGN):
            launches.append(t0)
            profile.marker()
    while True:
        t = time.perf_counter()
        frame()
        e = time.perf_counter()
        win.frame_s.append(e - t)
        if tracing:
            launches.append(e)
            profile.marker()
            if e - t0 >= min(trace_s, seconds):
                _sync(dev)
                prof.stop()
                tracing = False
        if e - t0 >= seconds:
            break
    _sync(dev)
    win.window_s = e - t0
    win.recording = False
    if dev.type == "cuda":
        win.memory_peak = int(torch.cuda.max_memory_allocated(dev))
    if prof is not None:
        win.trace = profile.reduce(prof, launches, win.phases)


def progressive(cell, seed: int, seconds: float, trace: bool, dev,
                t_start: float) -> Window:
    """Back-to-back blocking progressive frames of a static camera."""
    from raytracer_tpu_torch.runtime.renderer import Renderer
    win = Window()
    scene, use_sky = program_scene(cell, dev)
    r = Renderer(scene, camera_of(cell, cell.config["camera"]),
                 settings_of(cell, use_sky), seed=seed & 0xFFFFFFFF,
                 device=dev)
    for _ in range(cell.traffic["warmup_frames"]):
        r.render_frame(block=True)
    _sync(dev)
    win.setup_s = time.perf_counter() - t_start

    def frame():
        with win.span("render", trace):
            r.render_frame(block=True)

    _measure(win, dev, seconds,
             cell.traffic["trace_seconds"] if trace else 0.0, frame)
    tiles, slots, k = check_lanes(cell, seed, dev)
    pos = render.lane_positions(tiles, slots, k)
    real = pos < cell.traffic["width"] * cell.traffic["height"]
    # the frames the harness drove, not the program's own count
    frames = cell.traffic["warmup_frames"] + win.frames
    win.checked = {"film": r.accum[pos[real]].cpu(), "frames": frames,
                   "lanes": (tiles, slots, k)}
    return win


MODES = {"progressive": progressive}


def driver(cell):
    """The driver of the cell's traffic ``mode``."""
    mode = cell.traffic["mode"]
    if mode not in MODES:
        raise ValueError(f"no driver for mode {mode!r}; modes: "
                         f"{sorted(MODES)}")
    return MODES[mode]
