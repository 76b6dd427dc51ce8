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
- Launch accounting: ``build.launch`` counts a launch when Python issues
  it, which a replay does not do. A capture takes the program counts
  (utils/trace.py) before and after its body, keeps the difference as the
  graph's launches and takes it back off (a capture runs nothing); each
  replay adds it again. ``"graph.replay"`` counts the graph launches the
  host issued, ``"graph.capture"`` the captures.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..utils import trace
from . import intersect_cuda


class Graph:
    """A captured body and the kernel launches (a Counter of entry point
    and arm names) one replay of it makes."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for name, k in self.launches.items():
            trace.count(name, k)
        trace.count("graph.replay")


def warm_up(ws, n: int) -> None:
    """What must not happen inside a capture: load the kernel library and
    query the resident threads the group rule of ``ws``'s hit kernel
    reads (cached per group and device). Launches nothing."""
    build.load()
    if ws.blocked:
        intersect_cuda.blocked_group(n)
    else:
        intersect_cuda.resolve_group(n, ws.packed)


def capture(ws, n: int, body) -> Graph:
    """Capture ``body()`` (the launches of ``n``-lane iterations over
    ``ws``) into a CUDA graph, after ``warm_up``. Raises if the capture
    fails; the counts are left as they were."""
    warm_up(ws, n)
    before = trace.counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            body()
    finally:
        launches = trace.counts() - before
        for name, k in launches.items():
            trace.count(name, -k)
    trace.count("graph.capture")
    return Graph(graph, launches)
