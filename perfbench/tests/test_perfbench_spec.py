"""BENCHMARK.json against the benchmark's contract, and every file it
names: the configurations, traffic, check and metric reader files the
harness finds by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits the driver's time
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _one_line(c["source"])
    assert _one_line(c["why"]) and c["reduced"] == []
    assert c["file"].startswith("perfbench/configs/")
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert os.path.exists(os.path.join(ROOT, c["file"][:-5] + ".py"))
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _one_line(w["why"])
    assert w["config"] in {c["name"] for c in SPEC["configs"]}
    for sub, name in (("traffic", w["traffic"]), ("workloads", w["name"])):
        assert os.path.exists(os.path.join(BENCH, sub, name + ".json"))
    with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
        check = json.load(f)
    assert check["lanes"] >= 256 and check["limits"]
    reported = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]])
               for m in SPEC["per_layer"])
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    """Its reader exists, found by its name or its stem, and states
    nothing that BENCHMARK.json states: that is the one place."""
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert _one_line(m["layer"]) and m["moves"] in E2E
    for cell in m["workloads"]:
        assert cell in E2E[m["moves"]].get("workloads", [cell])
    from pbench import spec
    reader = spec.load_module(spec.reader_path(BENCH, m["name"]), "r")
    assert callable(reader.read)
    assert not {"LAYER", "UNIT", "SOURCE", "MOVES"} & set(vars(reader))


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_layers_share_one_name():
    """Metrics of one layer name it letter for letter."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"integrator", "wavefront ops", "kernels", "device"}
