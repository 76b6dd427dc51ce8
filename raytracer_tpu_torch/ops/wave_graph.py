"""CUDA-graph replay of the wavefront samplers' iterations.

The JAX package runs a wavefront frame inside one jitted step: the regen
loop is a ``lax.while_loop`` and the scan sampler a ``lax.scan`` over
bounces (raytracer_tpu/ops/integrator.py:186, 246-356, 431), so the
device runs the frame without the host. The port's loop is Python, and
on the card each iteration is three kernel launches (``rt_wave_rays``,
K5 or K6, ``rt_wave_bounce``, coherent sampling too: its tile draw and
the iteration counter's step happen inside ``rt_wave_rays``; rebin /
lanesort add their regrouping). Here those iterations are
captured once into a ``torch.cuda.CUDAGraph`` on static tensors and
replayed: one launch from the host per block of iterations
(ops/integrator.py decides what a block holds).

- ``capture(ws, n, body)`` loads the kernel library and fills the group
  rules' occupancy cache (no launch), then captures ``body``'s launches.
  A capture that fails raises; nothing runs eagerly in its place.
- ``ws.graphs``, the WaveScene's cache, holds one runner (static
  tensors and their graphs, ops/integrator.py) per (kind, N, settings,
  backend), so a Renderer's frames, ``render_sample_mean`` and ``trace``
  on one WaveScene capture once and replay after that; a new camera,
  frame key or tile offset is written into the runner's static tensors,
  not recaptured.
- Launch accounting: the kernel wrappers count a launch when Python
  issues it, which a replay does not do. A capture counts the launches
  its body issued (``COUNTERS``), takes them back off the counters (a
  capture runs nothing), and each replay adds them again; ``REPLAYS``
  counts the graph launches the host issued, ``CAPTURES`` the captures.
"""

from __future__ import annotations

import torch

from . import bounce, intersect_cuda, rays, rng

# The kernels' launch counters a graph holds launches of.
COUNTERS = ((intersect_cuda, "LAUNCHES"), (intersect_cuda, "STATS_LAUNCHES"),
            (intersect_cuda, "BLOCKED_LAUNCHES"),
            (intersect_cuda, "SKIP_LAUNCHES"), (rng, "LAUNCHES"),
            (rng, "TILE_LAUNCHES"), (bounce, "LAUNCHES"),
            (rays, "LAUNCHES"))
REPLAYS = 0
CAPTURES = 0


def counts() -> list:
    return [getattr(mod, name) for mod, name in COUNTERS]


def _set_counts(values) -> None:
    for (mod, name), v in zip(COUNTERS, values):
        setattr(mod, name, v)


class Graph:
    """A captured body and the kernel launches (per counter of
    ``COUNTERS``) one replay of it makes."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        global REPLAYS
        self.graph.replay()
        _set_counts([c + k for c, k in zip(counts(), self.launches)])
        REPLAYS += 1


def warm_up(ws, n: int) -> None:
    """What must not happen inside a capture: load the kernel library and
    query the resident threads the group rule of ``ws``'s hit kernel
    reads (cached per group and device). Launches nothing."""
    from ..kernels import build
    build.load()
    if ws.blocked:
        intersect_cuda.blocked_group(n)
    else:
        intersect_cuda.resolve_group(n, ws.packed)


def capture(ws, n: int, body) -> Graph:
    """Capture ``body()`` (the launches of ``n``-lane iterations over
    ``ws``) into a CUDA graph, after ``warm_up``. Raises if the capture
    fails; the counters are left as they were."""
    global CAPTURES
    warm_up(ws, n)
    before = counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            body()
        launches = [a - b for a, b in zip(counts(), before)]
    finally:
        _set_counts(before)
    CAPTURES += 1
    return Graph(graph, launches)
