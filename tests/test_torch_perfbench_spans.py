"""The benchmark's reduction of the port's host spans over a traced window
(perfbench/pbench/spans.py), on synthetic profiler events: idle device
time goes to the innermost open span, by overlap; spans belong to the
counted frames their starts fall in; the enqueue, exit-check and
check-idle numbers, and None where their spans are absent."""

import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.join(ROOT, "perfbench"))

from pbench import profile, spans  # noqa: E402

FRAME_MS = 20.0
MS = 1e-3


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    name: str
    device_type: str
    time_range: Range


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# frame-relative host ms: the harness's render phase, then the program's
# spans, then the device ops (ms after the frame's launch)
MEGA = {"spans": [("frame", 0.1, 0.6), ("frame.key", 0.1, 0.2),
                  ("mega.launch", 0.4, 0.6), ("frame.sync", 0.6, 19.8)],
        "ops": [(0.7, 18.7)]}
REGEN = {"spans": [("frame", 0.1, 19.0), ("regen.check", 1.0, 2.0),
                   ("regen.replay", 2.0, 2.2), ("regen.check", 6.0, 7.0),
                   ("regen.replay", 7.0, 7.2), ("regen.check", 11.0, 11.5),
                   ("frame.sync", 19.0, 19.8)],
         "ops": [(2.5, 6.5), (7.5, 18.7)]}


def _window(frames, kind, drop_marks=()):
    """(profiler, launches, harness phases, program spans) of ``frames``
    frames of ``kind``; the marker of launch j runs 8 us after it, on a
    profiler clock 5 ms past the host's."""
    t0 = 100.0
    launches = [t0 + j * FRAME_MS * MS for j in range(frames + 1)]
    zero = 5000.0 - t0 * 1e6

    def dev(t_host, ms=0.0):
        return t_host * 1e6 + zero + ms * 1e3

    events = [Event(profile.ALIGN, "DeviceType.CPU",
                    Range(dev(t0), dev(t0, 0.003)))]
    phases, program = [], []
    for j, t in enumerate(launches):
        if j not in drop_marks:
            events.append(Event(profile.MARKER, "DeviceType.CUDA",
                                Range(dev(t, 0.008), dev(t, 0.009))))
        if j == frames:
            break
        phases.append(("render", t + 0.05 * MS, t + 19.9 * MS))
        for name, a, b in kind["spans"]:
            program.append((name, t + a * MS, t + b * MS, None, j))
        for a, b in kind["ops"]:
            events.append(Event("void kernel(Args)", "DeviceType.CUDA",
                                Range(dev(t, a), dev(t, b))))
    return Prof(events), launches, phases, program


def test_innermost_names_each_instant_by_the_innermost_interval():
    got = spans.innermost([
        ("render", 0.0, 10.0), ("frame", 1.0, 6.0), ("frame.key", 1.0, 2.0),
        ("mega.launch", 4.0, 5.0), ("frame.sync", 6.0, 9.0),
        ("image.copy", 12.0, 13.0)])
    assert got == [(0.0, 1.0, "render"), (1.0, 2.0, "frame.key"),
                   (2.0, 4.0, "frame"), (4.0, 5.0, "mega.launch"),
                   (5.0, 6.0, "frame"), (6.0, 9.0, "frame.sync"),
                   (9.0, 10.0, "render"), (12.0, 13.0, "image.copy")]


def test_idle_by_innermost_span_and_enqueue():
    prof, launches, phases, program = _window(6, MEGA)
    out = spans.reduce(prof, launches, phases, program)
    assert out["frames"] == 6
    # idle: launch+8us .. K1 (0.692 ms), K1's end .. next marker (1.308)
    want = {"harness": 0.042 + 0.108, "render": 0.05 + 0.1,
            "frame.key": 0.1, "frame": 0.2, "mega.launch": 0.2,
            "frame.sync": 0.1 + 1.1}
    assert out["idle_ms"] == pytest.approx(want)
    tr = profile.reduce(prof, launches, phases)
    assert sum(out["idle_ms"].values()) * MS * 6 == pytest.approx(
        tr.window_s - tr.busy_s)
    assert sum(out["host_ms"].values()) == pytest.approx(FRAME_MS)
    assert out["host_ms"]["frame.sync"] == pytest.approx(19.2)
    assert out["enqueue_ms"] == pytest.approx(0.5)
    assert out["exit_checks"] is None and out["check_idle_ms"] is None


def test_regen_exit_checks_and_their_idle():
    prof, launches, phases, program = _window(5, REGEN)
    out = spans.reduce(prof, launches, phases, program)
    assert out["exit_checks"] == 3.0
    # check 1.0 + replay 0.2 in the first gap, 0.5 + 0.2 in the second
    assert out["check_idle_ms"] == pytest.approx(1.9)
    assert out["idle_ms"]["regen.check"] == pytest.approx(1.5)
    assert out["enqueue_ms"] is None


def test_spans_map_to_the_counted_frames_only():
    """A dropped marker takes its two frames out, and their spans."""
    prof, launches, phases, program = _window(10, REGEN, drop_marks=(5,))
    out = spans.reduce(prof, launches, phases, program)
    assert out["frames"] == 8
    assert out["exit_checks"] == 3.0
    assert out["check_idle_ms"] == pytest.approx(1.9)
    # a span that starts in a frame the profiler lost counts nowhere
    extra = program + [("regen.check", launches[4] + 1 * MS,
                        launches[4] + 1.5 * MS, None, 4)]
    assert spans.reduce(prof, launches, phases, extra)["exit_checks"] == 3.0


def test_nothing_to_read_without_spans_or_frames():
    prof, launches, phases, _ = _window(4, MEGA)
    assert spans.reduce(prof, launches, phases, []) == {"frames": 4}
    _, launches, phases, program = _window(4, MEGA)
    assert spans.reduce(Prof([]), launches, phases, program) == {"frames": 0}
