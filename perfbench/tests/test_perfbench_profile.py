"""The traced window's reduction on synthetic profiler events: device
time a frame counts only the frames whose two markers were recorded,
and a marker the profiler dropped takes both of its frames out."""

from __future__ import annotations

import dataclasses

import pytest

from conftest import BENCH

FRAME_S = 0.020
K1_US = 18_000.0


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


def _window(frames, drop_marks=(), drop_k1=(), align=True):
    """Launch host times and the profiler of a window of ``frames``
    frames: marker j after frame j (marker 0 at the opening), each frame
    one K1 and one copy. The profiler clock runs 5 ms after the host's
    zero."""
    from pbench import profile
    t0 = 100.0
    launches = [t0 + j * FRAME_S for j in range(frames + 1)]
    zero = 5000.0 - t0 * 1e6          # profiler us of host time 0

    def dev(t_host, us=0.0):
        return t_host * 1e6 + zero + us

    events = [Event(profile.ALIGN, "DeviceType.CPU",
                    Range(dev(t0), dev(t0, 3.0)))] if align else []
    for j, t in enumerate(launches):
        if j not in drop_marks:
            events.append(Event(profile.MARKER, "DeviceType.CUDA",
                                Range(dev(t, 8.0), dev(t, 9.0))))
        if j == frames:
            break
        if j + 1 not in drop_k1:
            events.append(Event("void megakernel<1>(Args)", "DeviceType.CUDA",
                                Range(dev(t, 200.0), dev(t, 200.0 + K1_US))))
        events.append(Event("Memcpy DtoD", "DeviceType.CUDA",
                            Range(dev(t, 18_500.0), dev(t, 18_600.0))))
    return Prof(events), launches


def _k1(tr):
    from pbench import spec
    reader = spec.load_module(spec.reader_path(BENCH, "k1_ms.progressive"),
                              "k1")
    return reader.read(type("Ctx", (), {"trace": tr})())


def test_every_frame_recorded():
    from pbench import profile
    prof, launches = _window(10)
    tr = profile.reduce(prof, launches, [])
    assert (tr.frames, tr.traced, tr.ops) == (10, 10, 20)
    assert tr.count("megakernel") == 10
    assert _k1(tr) == pytest.approx(K1_US / 1e3)
    assert tr.window_s == pytest.approx(10 * FRAME_S)
    assert tr.busy_s == pytest.approx(10 * (K1_US + 100.0) * 1e-6)


def test_a_dropped_marker_takes_out_its_two_frames():
    from pbench import profile
    prof, launches = _window(10, drop_marks=(4,))
    tr = profile.reduce(prof, launches, [])
    assert (tr.frames, tr.traced) == (8, 10)
    assert tr.count("megakernel") == 8 and tr.ops == 16
    assert _k1(tr) == pytest.approx(K1_US / 1e3)
    assert tr.window_s == pytest.approx(8 * FRAME_S)


def test_a_dropped_first_marker_is_not_mistaken_for_it():
    """With the span, the second marker is matched to its own launch."""
    from pbench import profile
    prof, launches = _window(10, drop_marks=(0,))
    tr = profile.reduce(prof, launches, [])
    assert tr.frames == 9
    assert _k1(tr) == pytest.approx(K1_US / 1e3)


def test_no_opening_span_counts_no_frame():
    """Without the span that ties the clocks no marker is matched: no
    frame counts, and the traced run fails rather than guess."""
    from pbench import profile
    prof, launches = _window(10, align=False)
    tr = profile.reduce(prof, launches, [])
    assert (tr.frames, tr.traced) == (0, 10) and _k1(tr) is None


def test_kernels_dropped_inside_a_frame_silence_k1():
    """A frame whose markers were kept and its K1 lost: the one-a-frame
    count no longer matches, and the reader reads nothing."""
    from pbench import profile
    prof, launches = _window(10, drop_k1=(6,))
    tr = profile.reduce(prof, launches, [])
    assert tr.frames == 10 and tr.count("megakernel") == 9
    assert _k1(tr) is None


def test_idle_gaps_by_host_phase():
    from pbench import profile
    prof, launches = _window(4)
    phases = [("render", t, t + 0.0187) for t in launches[:-1]]
    tr = profile.reduce(prof, launches, phases)
    assert set(tr.gaps) == {"render", "harness"}
    idle = sum(tr.gaps.values())
    assert idle == pytest.approx(tr.window_s - tr.busy_s)

