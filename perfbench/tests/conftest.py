"""Fixtures of the benchmark's own tests: the harness and the reference
on the import path, and a checkout in a temporary directory whose cells
are the benchmark's cells at a size the CPU renders in about a second."""

from __future__ import annotations

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cells' traffic at a CPU test's size; everything else as committed
TINY = {"mode_progressive": dict(width=64, height=48, spp=3,
                                 warmup_frames=1)}


def make_root(tmp, extra_traffic=None, extra_cells=(), extra_checks=None,
              lanes=256):
    """A checkout at ``tmp``: BENCHMARK.json, the benchmark's directories
    linked, tiny traffic files and the cells' check files, and the extra
    cells' files (``extra_traffic``, ``extra_checks``: name -> content).
    Returns its path."""
    root = str(tmp)
    bench = os.path.join(root, "perfbench")
    os.makedirs(os.path.join(bench, "traffic"))
    os.makedirs(os.path.join(bench, "workloads"))
    for d in ("configs", "metrics", "pbench", "pbref"):
        os.symlink(os.path.join(BENCH, d), os.path.join(bench, d))
    os.symlink(os.path.join(ROOT, "assets"), os.path.join(root, "assets"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"] += list(extra_cells)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as f:
            t = json.load(f)
        t.update(TINY["mode_" + t["mode"]])
        with open(os.path.join(bench, "traffic", name), "w") as f:
            json.dump(t, f)
    for name, t in (extra_traffic or {}).items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    checks = dict(extra_checks or {})
    for w in spec["workloads"]:
        if w["name"] in checks:
            check = dict(checks[w["name"]])
        else:
            with open(os.path.join(BENCH, "workloads",
                                   w["name"] + ".json")) as f:
                check = json.load(f)
            check["lanes"] = lanes
        with open(os.path.join(bench, "workloads", w["name"] + ".json"),
                  "w") as f:
            json.dump(check, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))
