"""What the benchmark loads: nothing whose top-level module name is
``jax``, ``jaxlib``, ``flax`` or the JAX package's (``raytracer_tpu``,
compared whole: the port's name begins with it), and a reference that
loads nothing of the program either."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "raytracer_tpu"}
PROGRAM = "raytracer_tpu_torch"


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``, which runs with the benchmark and the checkout on its
    path."""
    prog = (f"import sys\nsys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    """A whole run of a cell of each sampler, the reference included, on
    the CPU at the tests' size."""
    names = _loaded(
        "import time, torch\nfrom pbench import cell, spec\n"
        "import run\n"
        f"for w in ('rtiow_scene4.progressive', 'earth_scene2.regen'):\n"
        f"    c = spec.load({tiny_root!r}, w)\n"
        "    out = cell.run(c, 7, 0.2, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "    assert out['correct'], out['checks']\n"
        "assert not run.forbidden_modules()\n")
    assert PROGRAM in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program(tiny_root):
    """The reference alone, scenes built from the configurations' files
    and a frame of each sampler."""
    names = _loaded(
        "import json, torch\nfrom pbench import spec\n"
        "from pbref import render, wave\n"
        f"c = spec.load({tiny_root!r}, 'earth_scene2.regen')\n"
        "sc = spec.reference_scene(c, 'cpu')\n"
        "t, s = render.choose_lanes(3, 64 * 48, 8, 16, 'cpu')\n"
        "kw = dict(spp=2, limit=5, antialias=True, sky=(0.0, 0.0, 0.0))\n"
        "render.progressive(sc, c.config['camera'], 64, 48, seed=3, "
        "frames=2, tiles=t, slots=s, k=8, **kw)\n"
        "wave.progressive(sc, c.config['camera'], 64, 48, seed=3, "
        "frames=2, positions=torch.arange(16), **kw)\n"
        f"c = spec.load({tiny_root!r}, 'rtiow_scene4.progressive')\n"
        "spec.reference_scene(c, 'cpu')\n")
    assert not names & (FORBIDDEN | {PROGRAM}), names & (FORBIDDEN | {PROGRAM})


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(*dirs):
    for d in dirs:
        for base, _, files in os.walk(os.path.join(BENCH, d)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(_sources("pbench", "pbref",
                                                 "configs", "metrics",
                                                 "tools")) +
                         [os.path.join(BENCH, "run.py")])
def test_no_source_imports_jax(path):
    names = _imports(path)
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    rel = os.path.relpath(path, BENCH)
    if rel.startswith(("pbref", "configs", "metrics")):
        assert PROGRAM not in names, (path, "the reference and the readers "
                                            "import nothing of the program")
