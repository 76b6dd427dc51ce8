"""A cell's files, found by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the deployment (scene, settings, camera)
  and ``configs/<config>.py``, its plain reference scene (``build``);
- ``traffic/<traffic>.json``: the traffic mix a general driver reads
  (``mode`` picks the driver in ``pbench.modes``);
- ``workloads/<cell>.json``: the cell's correctness check: how many
  lanes it samples and the limit of each number it compares;
- ``metrics/<metric>.py``, else ``metrics/<stem>.py`` (the name up to
  its first dot): one per-layer metric's reader, so ``k1_ms.progressive``
  and a later ``k1_ms.fly`` share ``k1_ms.py``. Names hold dots, so each
  is loaded by its path. BENCHMARK.json alone states a metric's layer,
  unit, source and the end-to-end metric it moves.

Adding a cell, a configuration or a metric adds files and entries; no
file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os


@dataclasses.dataclass
class Cell:
    name: str
    root: str            # the checkout: BENCHMARK.json and the program
    bench: str           # the benchmark's directory
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    check: dict
    end_to_end: list     # metric entries this cell reports
    per_layer: list
    config_file: str     # the configuration's JSON, relative to root

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file loaded by its path under a name of our choosing."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files."""
    bench_json = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench_json["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    entry = cells[name]
    bench = os.path.join(root, bench_json["paths"][0])
    configs = {c["name"]: c for c in bench_json["configs"]}
    config_file = configs[entry["config"]]["file"]
    config = _json(os.path.join(root, config_file))
    traffic = _json(os.path.join(bench, "traffic",
                                 entry["traffic"] + ".json"))
    check = _json(os.path.join(bench, "workloads", name + ".json"))
    e2e = [m for m in bench_json["end_to_end"] if _applies(m, name)]
    per = [m for m in bench_json["per_layer"] if _applies(m, name)]
    return Cell(name, root, bench, entry, config, traffic, check, e2e, per,
                config_file)


def render_settings(cell: Cell) -> dict:
    """The program's ``RenderSettings`` fields, by name: the
    configuration's ``settings`` (but ``use_sky``, the scene's own), the
    traffic's ``spp`` and ``sampler``, and the traffic's ``settings``."""
    out = {k: v for k, v in cell.config["settings"].items()
           if k != "use_sky"}
    out.update(rays_per_pixel=cell.traffic["spp"],
               sampler=cell.traffic["sampler"])
    out.update(cell.traffic.get("settings", {}))
    if "sky_colour" in out:
        out["sky_colour"] = tuple(out["sky_colour"])
    return out


def reference_scene(cell: Cell, device):
    """The configuration's plain reference scene, built by the file
    beside its JSON."""
    path = os.path.join(cell.root, os.path.splitext(cell.config_file)[0]
                        + ".py")
    mod = load_module(path, "pbref_config_" + cell.entry["config"])
    return mod.build(cell.config, cell.root, device)


def reader_path(bench: str, metric: str) -> str:
    """The file of per-layer metric ``metric``'s reader: its own, else
    the one of its stem."""
    own = os.path.join(bench, "metrics", metric + ".py")
    if os.path.exists(own):
        return own
    return os.path.join(bench, "metrics", metric.split(".")[0] + ".py")


def metric_reader(cell: Cell, metric: str):
    """The reader of per-layer metric ``metric``."""
    return load_module(reader_path(cell.bench, metric),
                       "pbench_metric_" + metric.replace(".", "_"))
