"""The port's host spans (raytracer_tpu_torch/utils/trace.py) over a
traced window, as ``tools/spans.py`` reads them.

The window's counted frames are ``profile.reduce``'s: a frame runs
between the recorded markers of two consecutive launches. Here each
counted frame also keeps its host interval, launch to launch, and its
device idle intervals, turned onto the host clock by the ``ALIGN`` span.
A program span belongs to the counted frame whose launches bracket its
start. At each instant the host is in the innermost open interval of the
program's spans and the harness's phases (``render``); outside them it
is in the harness.

Numbers a counted frame:
- ``idle_ms``: device idle ms by the host's innermost interval;
- ``host_ms``: host ms by the innermost interval (a span's self time);
- ``enqueue_ms``: ms from the start of the ``frame`` span to the end of
  its first ``mega.launch`` span (frames with one);
- ``exit_checks``: ``regen.check`` spans;
- ``check_idle_ms``: device idle ms that overlaps a ``regen.check`` or
  ``regen.replay`` span.
A number with no span to read is None.
"""

from __future__ import annotations

import bisect

from . import profile

HARNESS = "harness"


def counted_frames(prof, launches):
    """[(host start, host end, [idle (start, end)])] of the counted
    frames, host perf_counter seconds, in order."""
    events, align = profile._events(prof)
    events.sort(key=lambda e: e[1])
    marks = [e for e in events if profile.MARKER in e[0]]
    ops = [e for e in events if profile.MARKER not in e[0]]
    if align is None or not marks:
        return []
    shift = align * 1e-6 - launches[0]      # profiler us -> host s
    idx = [profile._nearest(launches, m[1] * 1e-6 - shift) for m in marks]
    frames = [(marks[j][1], marks[j + 1][1], idx[j])
              for j in range(len(marks) - 1) if idx[j + 1] == idx[j] + 1]
    starts = [f[0] for f in frames]
    idle = [[] for _ in frames]
    cur = [f[0] for f in frames]
    for _, s, e in ops:
        f = bisect.bisect_right(starts, s) - 1
        if f < 0 or s >= frames[f][1]:
            continue
        if s > cur[f]:
            idle[f].append((cur[f], s))
        cur[f] = max(cur[f], min(e, frames[f][1]))
    out = []
    for (f0, f1, i), gaps, c in zip(frames, idle, cur):
        if f1 > c:
            gaps.append((c, f1))
        out.append((launches[i], launches[i + 1],
                    [(a * 1e-6 - shift, b * 1e-6 - shift) for a, b in gaps]))
    return out


def innermost(intervals):
    """Disjoint (start, end, name) pieces of properly nested (name,
    start, end) intervals, each named by the innermost interval open
    there; instants outside every interval are left out."""
    out, stack, cur = [], [], None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for name, s, e in sorted(intervals, key=lambda x: (x[1], -x[2])):
        close_until(s)
        if stack and s > cur:
            out.append((cur, s, stack[-1][0]))
        cur = s
        stack.append((name, e))
    close_until(float("inf"))
    return out


def _overlap(a, b, pieces, starts, into: dict) -> None:
    """Add [a, b)'s overlap with each piece to ``into`` by name, the
    rest to HARNESS."""
    covered = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(pieces) and pieces[i][0] < b:
        s, e, name = pieces[i]
        d = min(b, e) - max(a, s)
        if d > 0:
            into[name] = into.get(name, 0.0) + d
            covered += d
        i += 1
    if b - a > covered:
        into[HARNESS] = into.get(HARNESS, 0.0) + (b - a - covered)


def reduce(prof, launches, phases, spans) -> dict:
    """The numbers above over the counted frames. ``spans``: the
    recorder's (name, start, end, parent, frame) in perf_counter
    seconds; ``phases``: the harness's (name, start, end)."""
    frames = counted_frames(prof, launches)
    n = len(frames)
    if not n or not spans:
        return {"frames": n}
    pieces = innermost([(s[0], s[1], s[2]) for s in spans] + list(phases))
    starts = [p[0] for p in pieces]
    f_starts = [f[0] for f in frames]
    per = [[] for _ in frames]
    for s in spans:
        f = bisect.bisect_right(f_starts, s[1]) - 1
        if f >= 0 and s[1] < frames[f][1]:
            per[f].append(s)
    idle, host, check_idle = {}, {}, 0.0
    enqueue, checks = [], 0
    for (h0, h1, gaps), mine in zip(frames, per):
        _overlap(h0, h1, pieces, starts, host)
        for a, b in gaps:
            _overlap(a, b, pieces, starts, idle)
        loop = [s for s in mine if s[0] in ("regen.check", "regen.replay")]
        check_idle += sum(max(0.0, min(b, s[2]) - max(a, s[1]))
                          for a, b in gaps for s in loop)
        checks += sum(s[0] == "regen.check" for s in mine)
        root = next((s for s in mine if s[0] == "frame"), None)
        launch = next((s for s in mine if s[0] == "mega.launch"), None)
        if root is not None and launch is not None:
            enqueue.append(launch[2] - root[1])

    def per_frame_ms(by: dict) -> dict:
        return {k: 1e3 * v / n
                for k, v in sorted(by.items(), key=lambda kv: -kv[1])}

    return {"frames": n, "idle_ms": per_frame_ms(idle),
            "host_ms": per_frame_ms(host),
            "enqueue_ms": 1e3 * sum(enqueue) / len(enqueue) if enqueue
            else None,
            "exit_checks": checks / n if checks else None,
            "check_idle_ms": 1e3 * check_idle / n if checks else None}
