"""The traced window: torch.profiler's device events reduced to device
time by kernel a frame, the device's busy time, and its idle gaps
labelled by what the host was doing.

The harness launches a marker kernel of its own (``torch.cuda._sleep``,
``spin_kernel``) as the window opens and after each frame, and records
the host time of each launch. A host-side span (``ALIGN``) at the
window's opening ties the profiler's clock to the host's, so each
recorded marker is matched to the launch nearest its start: launches
come a frame, milliseconds, apart, and a marker runs within microseconds
of its launch. The profiler may record only some of a long window's
device events, so a frame counts only where both of its markers were
recorded and are the markers of consecutive launches: its device ops are
the ops that start between them. Ops outside such frames, and the
markers themselves, are left out of every number.
"""

from __future__ import annotations

import bisect
import dataclasses

MARKER = "spin_kernel"
MARKER_CYCLES = 1000
ALIGN = "pbench.window_open"


@dataclasses.dataclass
class Trace:
    kernels: dict          # name -> [device seconds, count] over the frames
    busy_s: float          # union of device op intervals over the frames
    window_s: float        # device seconds of the frames, marker to marker
    frames: int            # frames counted: both markers recorded
    traced: int            # frames the traced window ran
    ops: int               # device ops of the counted frames
    gaps: dict             # host phase -> idle seconds over the frames
    lag_ms: float = 0.0    # median of a marker's start past its launch

    def device_s(self, *names: str) -> float:
        """Device seconds of the kernels whose names hold one of
        ``names``."""
        return sum(v[0] for k, v in self.kernels.items()
                   if any(n in k for n in names))

    def count(self, *names: str) -> int:
        """Launches of the kernels whose names hold one of ``names``."""
        return sum(v[1] for k, v in self.kernels.items()
                   if any(n in k for n in names))


def marker() -> None:
    import torch
    torch.cuda._sleep(MARKER_CYCLES)


def _events(prof):
    """(device events, the ALIGN span's start): every device op as
    (name, start_us, end_us), on the profiler's clock."""
    out, align = [], None
    for e in prof.events():
        tr = e.time_range
        if str(e.device_type).endswith("CUDA"):
            out.append((e.name, float(tr.start), float(tr.end)))
        elif e.name == ALIGN and align is None:
            align = float(tr.start)
    return out, align


def _nearest(xs, x) -> int:
    i = bisect.bisect_left(xs, x)
    if i == len(xs) or (i > 0 and x - xs[i - 1] <= xs[i] - x):
        return i - 1
    return i


def reduce(prof, launches, phases) -> Trace:
    """Reduce ``prof`` over a traced window. ``launches``: host times
    (perf_counter seconds) of the markers' launches, the first at the
    window's opening, where the ALIGN span was recorded; ``phases``:
    (name, start, end) host intervals, perf_counter seconds."""
    events, align = _events(prof)
    events.sort(key=lambda e: e[1])
    marks = [e for e in events if MARKER in e[0]]
    ops = [e for e in events if MARKER not in e[0]]
    traced = max(len(launches) - 1, 0)
    if align is None or not marks:
        return Trace({}, 0.0, 0.0, 0, traced, 0, {})
    shift = align * 1e-6 - launches[0]      # profiler us -> host s
    host = [m[1] * 1e-6 - shift for m in marks]
    idx = [_nearest(launches, h) for h in host]
    lags = sorted(h - launches[i] for h, i in zip(host, idx))
    # frame i runs between the markers of launches i - 1 and i
    frames = [(marks[j][1], marks[j + 1][1]) for j in range(len(marks) - 1)
              if idx[j + 1] == idx[j] + 1]
    starts = [f[0] for f in frames]
    kernels: dict = {}
    busy = 0.0
    gaps: dict = {}
    n_ops = 0
    phases = sorted(phases, key=lambda p: p[1])

    def phase_at(t):
        for name, s, e in phases:
            if s <= t < e:
                return name
        return "harness"

    def idle(a, b):
        label = phase_at(0.5 * (a + b) * 1e-6 - shift)
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6

    per_frame = [[] for _ in frames]
    for op in ops:
        f = bisect.bisect_right(starts, op[1]) - 1
        if f >= 0 and op[1] < frames[f][1]:
            per_frame[f].append(op)
    for (f0, f1), f_ops in zip(frames, per_frame):
        cur = f0
        for name, s, e in f_ops:
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (e - s) * 1e-6
            k[1] += 1
            n_ops += 1
            e = min(e, f1)
            if s > cur:
                idle(cur, s)
            if e > max(s, cur):
                busy += e - max(s, cur)
            cur = max(cur, e)
        if f1 > cur:
            idle(cur, f1)
    window = sum(f1 - f0 for f0, f1 in frames)
    return Trace(kernels, busy * 1e-6, window * 1e-6, len(frames), traced,
                 n_ops, gaps, 1e3 * lags[len(lags) // 2])


def breakdown(tr: Trace) -> dict:
    """The ten device ops that took most time and the idle time by host
    phase, each [name, seconds]."""
    top = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(tr.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[_short(k), v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list, at most 96 characters."""
    n = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return n[:96]
