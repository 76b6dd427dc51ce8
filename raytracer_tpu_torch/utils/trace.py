"""Host spans of the frame loop, recorded in memory while enabled.

``span(name)`` times a block on ``time.perf_counter_ns``, the clock the
benchmark's host markers use, and records ``(name, start_ns, end_ns,
parent, frame)``: ``parent`` is the index of the enclosing open span
(the frame loop runs on one thread), ``frame`` the frame number its root
span was opened with, which its children inherit. Off (the default)
``span`` returns one shared null context: no allocation, no clock read,
no torch call. ``take`` hands the recorded spans over and clears them;
``write_jsonl`` writes them out (``render --spans PATH``).

The spans and what reads them are listed in PERF.md §3.

Beside the spans, one registry of program counts, always on:
``count(name, k)`` adds ``k`` under ``name`` and ``counts()`` returns a
copy. The names:

- ``"rt_X"``: launches of entry point ``rt_X`` that Python issued or a
  replayed CUDA graph held (``kernels/build.py`` ``launch`` counts them);
- ``"rt_X.arm"``: of those, the launches of one arm, counted by the
  wrapper that picks it: ``rt_megakernel.image`` (a texel plane, so K4
  runs inside), ``rt_megakernel.coherent``, ``rt_hit_resolve.stats`` (the
  counting arm) and ``rt_hit_resolve.skip`` / ``rt_hit_resolve_blocked.skip``
  (the regen loop's skip of finished lanes);
- ``"graph.capture"`` / ``"graph.replay"``: CUDA graphs captured and
  replays issued (ops/wave_graph.py);
- ``"regen.lane_iterations"``: N x k for every block of k regen
  iterations (ops/integrator.py).
"""

from __future__ import annotations

import collections
import contextlib
import json
import time

_NULL = contextlib.nullcontext()
_on = False
_spans: list = []   # [name, start_ns, end_ns, parent, frame]
_open: list = []    # indices into _spans of the open spans, innermost last


def enable(on: bool = True) -> None:
    """Record spans from now on (``on``), or stop recording."""
    global _on
    _on = bool(on)


def span(name: str, frame=None):
    """A context manager that records the block as span ``name``;
    ``frame`` is given by a frame's root spans, else inherited."""
    if not _on:
        return _NULL
    return _record(name, frame)


@contextlib.contextmanager
def _record(name: str, frame):
    parent = _open[-1] if _open else None
    if frame is None and parent is not None:
        frame = _spans[parent][4]
    i = len(_spans)
    _spans.append([name, time.perf_counter_ns(), None, parent, frame])
    _open.append(i)
    try:
        yield
    finally:
        _open.pop()
        _spans[i][2] = time.perf_counter_ns()


def take() -> list:
    """The spans recorded since the last ``take``, as (name, start_ns,
    end_ns, parent, frame) tuples, and clears them. Call it outside any
    open span: ``parent`` indexes the list it returns."""
    out = [tuple(s) for s in _spans]
    _spans.clear()
    return out


def write_jsonl(path: str, spans) -> None:
    """One JSON object a span: ``name``, ``frame``, ``start_us`` (on the
    perf_counter clock), ``dur_us`` and ``parent`` (a line index)."""
    with open(path, "w") as f:
        for name, start, end, parent, frame in spans:
            f.write(json.dumps({"name": name, "frame": frame,
                                "start_us": start / 1e3,
                                "dur_us": (end - start) / 1e3,
                                "parent": parent}) + "\n")


_counts: collections.Counter = collections.Counter()


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the program count ``name``."""
    _counts[name] += k


def counts() -> collections.Counter:
    """A copy of the program counts."""
    return _counts.copy()
