"""The port's host span recorder (raytracer_tpu_torch/utils/trace.py):
off it records nothing, reads no clock and allocates nothing; on it
records names, nesting and frame ids; a CPU Renderer's frames emit the
spans of PERF.md §3 in order, and render bitwise as with spans off; the
CLI's ``--spans`` writes them out. And its program counts as
``kernels/build.py``'s ``launch`` keeps them."""

import collections
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.__main__ import main
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def recorder_off():
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


def _renderer(sampler="auto", spp=1, temporal=False):
    scene, sky = rtt.build_scene(1, device="cpu")
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=3,
                                  sampler=sampler).with_sky(sky)
    cam = rtt.CameraConfig(width=16, height=12)
    return rtt.Renderer(scene, cam, settings, seed=3, device="cpu",
                        temporal=temporal)


def _frame(r, block=True):
    """The spans of one frame: (name, parent name, frame id) each."""
    trace.enable()
    r.render_frame(block=block)
    trace.enable(False)
    spans = trace.take()
    return [(n, None if p is None else spans[p][0], f)
            for n, _, _, p, f in spans]


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("span read the clock while off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    a, b = trace.span("frame", 0), trace.span("mega.launch")
    assert a is b
    with a:
        with b:
            pass
    assert trace.take() == []


def _live_in_recorder() -> int:
    """Bytes allocated by trace.py and alive inside one span's block."""
    mine = tracemalloc.Filter(True, trace.__file__)
    tracemalloc.start()
    try:
        with trace.span("regen.check"):
            snap = tracemalloc.take_snapshot().filter_traces([mine])
    finally:
        tracemalloc.stop()
    return sum(s.size for s in snap.statistics("filename"))


def test_off_allocates_nothing():
    assert _live_in_recorder() == 0
    trace.enable()                           # the measure sees a span on
    assert _live_in_recorder() > 0


def test_on_records_names_nesting_and_frame():
    trace.enable()
    with trace.span("frame", 7):
        with trace.span("frame.key"):
            pass
        with trace.span("mega.launch"):
            with trace.span("inner"):
                pass
    with trace.span("frame.sync", 7):
        pass
    with trace.span("image.copy"):
        pass
    trace.enable(False)
    with trace.span("after"):
        pass
    spans = trace.take()
    assert [(n, p, f) for n, _, _, p, f in spans] == [
        ("frame", None, 7), ("frame.key", 0, 7), ("mega.launch", 0, 7),
        ("inner", 2, 7), ("frame.sync", None, 7), ("image.copy", None, None)]
    for _, s, e, p, _ in spans:
        assert s <= e
        if p is not None:
            assert spans[p][1] <= s and e <= spans[p][2]
    assert trace.take() == []


def test_span_closes_when_the_block_raises():
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("frame", 0):
            raise ValueError("x")
    with trace.span("frame.sync", 0):
        pass
    spans = trace.take()
    assert [(n, p) for n, _, _, p, _ in spans] == [("frame", None),
                                                  ("frame.sync", None)]
    assert spans[0][2] is not None


def test_write_jsonl(tmp_path):
    spans = [("frame", 1_000_000, 3_500_000, None, 4),
             ("mega.launch", 2_000_000, 2_250_000, 0, 4)]
    path = tmp_path / "spans.jsonl"
    trace.write_jsonl(str(path), spans)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == [
        {"name": "frame", "frame": 4, "start_us": 1000.0, "dur_us": 2500.0,
         "parent": None},
        {"name": "mega.launch", "frame": 4, "start_us": 2000.0,
         "dur_us": 250.0, "parent": 0}]


def test_megakernel_frame_spans():
    r = _renderer()
    r.render_frame(block=True)
    assert _frame(r) == [
        ("frame", None, 1), ("frame.key", "frame", 1),
        ("mega.pad", "frame", 1), ("mega.launch", "frame", 1),
        ("mega.segs", "frame", 1), ("film.update", "frame", 1),
        ("frame.sync", None, 1)]
    # no sync, no frame.sync
    assert [n for n, _, _ in _frame(r, block=False)][-1] == "film.update"


def test_regen_frame_spans():
    r = _renderer("regen", spp=4)
    got = _frame(r)
    names = [n for n, _, _ in got]
    assert names[:3] == ["frame", "frame.key", "regen.keys"]
    assert names[3] == "regen.reset"
    loop = names[4:names.index("regen.finish")]
    assert loop[::2] == ["regen.check"] * len(loop[::2])
    assert loop[1::2] == ["regen.replay"] * len(loop[1::2])
    assert len(loop) >= 3                    # the frame looks more than once
    assert names[names.index("regen.finish"):] == [
        "regen.finish", "film.update", "frame.sync"]
    assert all(f == 0 for _, _, f in got)
    assert all(p == "frame" for n, p, _ in got
               if n not in ("frame", "frame.sync"))


def test_temporal_frame_spans():
    r = _renderer(temporal=True)
    first = _frame(r)
    assert first == [
        ("frame", None, 0), ("frame.key", "frame", 0),
        ("temporal.rays", "frame", 0), ("mega.launch", "frame", 0),
        ("temporal.epilogue", "frame", 0), ("frame.sync", None, 0)]
    # the rays are built at a camera's first frame only
    assert "temporal.rays" not in [n for n, _, _ in _frame(r)]


def test_render_frames_spans():
    r = _renderer()
    trace.enable()
    r.render_frames(3)
    spans = trace.take()
    roots = [(n, f) for n, _, _, p, f in spans if p is None]
    assert roots == [("frame", 0), ("frame", 1), ("frame", 2),
                     ("frame.sync", 2)]


def test_image_spans_and_spans_change_no_output():
    plain, traced = _renderer("regen", spp=2), _renderer("regen", spp=2)
    for _ in range(2):
        plain.render_frame(block=True)
    img = plain.image()
    trace.enable()
    for _ in range(2):
        traced.render_frame(block=True)
    trace.take()
    got = traced.image()
    assert [(n, p) for n, _, _, p, _ in trace.take()] == [
        ("image.copy", None), ("image.to_u8", None)]
    assert torch.equal(plain.accum, traced.accum)
    np.testing.assert_array_equal(img, got)


def test_cli_writes_spans(tmp_path):
    spans, stats = tmp_path / "spans.jsonl", tmp_path / "stats.jsonl"
    rc = main(["render", "--scene", "1", "--device", "cpu", "--width", "16",
               "--height", "12", "--spp", "1", "--bounces", "2",
               "--frames", "2", "--out", str(tmp_path / "o.png"),
               "--stats", str(stats), "--spans", str(spans)])
    assert rc == 0
    rows = [json.loads(line) for line in spans.read_text().splitlines()]
    roots = [(r["name"], r["frame"]) for r in rows if r["parent"] is None]
    assert roots == [("scene.build", None), ("frame", 0), ("frame.sync", 0),
                     ("frame", 1), ("frame.sync", 1), ("image.copy", None),
                     ("image.to_u8", None)]
    # the scene build's children: the Woop loop, then the BVH levels
    assert [r["name"] for r in rows if r["parent"] == 0] == [
        "scene.woop", "scene.bvh"]
    assert all(r["dur_us"] >= 0 for r in rows)
    assert len(stats.read_text().splitlines()) == 2
    assert trace.span("x") is trace.span("y")   # the CLI turned it off


def test_launch_calls_the_entry_point_and_counts_it(monkeypatch):
    """``build.launch`` calls entry point ``name`` with its argument
    struct and the device's stream and counts ``name``; a nonzero return
    raises with the name and the error string and counts nothing. A stub
    stands in for the kernel library: no nvcc, no card."""
    from raytracer_tpu_torch.kernels import build

    class _Lib:
        rc = 0

        def __init__(self):
            self.calls = []

        def rt_fetch_image(self, args, stream):
            self.calls.append((args._obj, stream.value))
            return self.rc

        def rt_error_string(self, rc):
            return b"invalid argument"
    lib = _Lib()
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(build, "stream", lambda device: 1234)
    monkeypatch.setattr(trace, "_counts", collections.Counter())
    args = build.FetchArgs(n=7)
    build.launch("rt_fetch_image", args, torch.device("cpu"))
    assert lib.calls == [(args, 1234)]
    assert trace.counts() == {"rt_fetch_image": 1}
    trace.counts()["rt_fetch_image"] += 1       # a copy
    lib.rc = 1
    with pytest.raises(RuntimeError, match=r"rt_fetch_image launch failed: "
                       r"cudaError 1 \(invalid argument\)"):
        build.launch("rt_fetch_image", args, torch.device("cpu"))
    assert len(lib.calls) == 2
    assert trace.counts() == {"rt_fetch_image": 1}
