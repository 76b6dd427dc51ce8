"""Every cell end to end on the CPU at a tiny size, past the harness's look
for a card: the run is correct; the bfloat16 control and each fault the
cells can have, planted in the timed path, make it incorrect; a cell
added as files only runs."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from conftest import BENCH, make_root

with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
SEED = 5_000_000_017     # past 32 bits, as the driver's seeds are


def run(root, name, control=False, seconds=0.5, trace=False):
    from pbench import cell, spec
    c = spec.load(root, name)
    return cell.run(c, SEED, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct(tiny_root, name):
    out = run(tiny_root, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(v == 0.0 for _, v, _ in out["checks"]), out["checks"]
    assert "setup_s" in out["metrics"]
    assert len(out["metrics"]) >= 2


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_root, name):
    out = run(tiny_root, name, control=True)
    assert not out["correct"], out["checks"]


def _stale(mp):
    """A step that returns its state unchanged (after doing its work, so
    the window holds as many frames as a sound one)."""
    import raytracer_tpu_torch.runtime.renderer as renderer
    real = renderer.render_frame

    def stale(scene, settings, o, d, accum, *a, **k):
        _, segs = real(scene, settings, o, d, accum.clone(), *a, **k)
        return accum, segs
    mp.setattr(renderer, "render_frame", stale)


def _half(mp):
    """Half of the batch left out: half the samples, the mean over the
    rest."""
    import dataclasses

    import raytracer_tpu_torch.ops.integrator as integrator
    real = integrator.render_sample_mean

    def half_samples(scene, settings, *a, **k):
        s = dataclasses.replace(
            settings, rays_per_pixel=max(1, settings.rays_per_pixel // 2))
        return real(scene, s, *a, **k)
    mp.setattr(integrator, "render_sample_mean", half_samples)


def _altered(mp):
    """An answer altered where it is produced: every 16th pixel's red
    value off by one u8 step."""
    import raytracer_tpu_torch.ops.integrator as integrator
    real = integrator.render_sample_mean

    def bent(*a, **k):
        mean, segs = real(*a, **k)
        mean = mean.clone()
        mean[::16, 0] += 1.0 / 255.0
        return mean, segs
    mp.setattr(integrator, "render_sample_mean", bent)


def _extra_frame(mp):
    """The program renders a frame more than the harness asked for, and
    counts it: the film is the program's own, over another count."""
    from raytracer_tpu_torch.runtime.renderer import Renderer
    real = Renderer.render_frame
    state = {"first": True}

    def twice(self, *a, **k):
        if state.pop("first", False):
            real(self, *a, **k)
        return real(self, *a, **k)
    mp.setattr(Renderer, "render_frame", twice)


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _extra_frame],
                         ids=["state_unchanged", "half_batch", "altered",
                              "extra_frame"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_root, name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(tiny_root, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("change", [
    ("traffic", "sampler", "scan"),
    ("traffic", "settings", {"coherent": True}),
    ("traffic", "settings", {"russian_roulette": 3}),
    ("traffic", "mode", "fly"),
    ("config", "program", {"call": "raytracer_tpu_torch.utils.device."
                                   "resolve_device"}),
    ("config", "program", {"call": "math.hypot", "args": [3, 4]}),
], ids=["sampler", "coherent", "roulette", "mode", "scene_form",
        "not_the_port"])
def test_what_the_reference_does_not_model_raises(tiny_root, change):
    """A sampler, a setting, a mode or a scene function's result that the
    harness does not model raises before the check, never passes by
    another path's reference."""
    import dataclasses

    from pbench import spec
    c = spec.load(tiny_root, CELLS[0])
    part, key, value = change
    c = dataclasses.replace(c, **{part: {**getattr(c, part), key: value}})
    with pytest.raises((ValueError, TypeError)):
        cell_run(c)


def cell_run(c):
    from pbench import cell
    return cell.run(c, SEED, 0.2, False, torch.device("cpu"),
                    time.perf_counter())


def test_cell_added_as_files(tmp_path):
    """A new traffic mix and a new cell are data: a traffic file, a check
    file and BENCHMARK.json entries, and the harness runs it."""
    traffic = {"mode": "progressive", "why": "a smaller film", "width": 40,
               "height": 24, "spp": 2, "sampler": "auto",
               "warmup_frames": 1}
    entry = {"name": "earth_scene2.extra", "config": "earth_scene2",
             "traffic": "extra", "chips": 1, "why": "a throwaway cell"}
    root = make_root(tmp_path, {"extra": traffic}, [entry],
                     {"earth_scene2.extra": {"lanes": 64,
                                             "limits": {"film_gap": 0.0}}})
    # the cell reports a rate: it joins that metric's list of cells
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    for m in spec["end_to_end"]:
        if m["name"] == "msamples_per_s":
            m["workloads"].append(entry["name"])
    with open(path, "w") as f:
        json.dump(spec, f)
    out = run(root, "earth_scene2.extra")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"msamples_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(tiny_root, name, monkeypatch):
    """A traced run on the CPU has no device trace: the host-clock
    readers report, the device readers find nothing and stay silent."""
    from pbench import profile, spec
    monkeypatch.setattr(profile, "marker", lambda: None)
    monkeypatch.setattr(profile, "reduce",
                        lambda prof, launches, phases: profile.Trace(
                            {}, 0.0, 0.0, 0, len(launches) - 1, 0, {}))
    out = run(tiny_root, name, trace=True)
    c = spec.load(tiny_root, name)
    host = {m["name"] for m in c.per_layer if m["source"] == "host_clock"}
    assert set(out["metrics"]) == host
    assert out["correct"]
