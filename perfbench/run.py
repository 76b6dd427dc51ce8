"""Run one cell of the benchmark of ``raytracer_tpu_torch`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
check are found by name from ``BENCHMARK.json``. The run builds the
program's kernels into the checkout's ``build/`` (reused by later runs),
warms every shape the window uses, measures for ``--seconds``, checks
the window's output against the plain reference, and prints as its last
line one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones) and ``device``, then ``checks`` (each compared number beside its
limit). It fails without a CUDA device, and if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _caches() -> None:
    """Keep every kernel cache of the run inside the checkout, at fixed
    paths: the port builds into build/kernels and build/host itself."""
    base = os.path.join(ROOT, "build", "perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def card_line() -> dict:
    """The card's name, power limit and clocks from nvidia-smi, for an
    earlier line of the output."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return {"nvidia_smi": out}


def main(argv=None, control: bool = False) -> int:
    """A run of the cell; with ``control`` the bfloat16 reference takes
    the program's place in the check (perfbench/tools/control.py)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, HERE)
    import torch
    from pbench import cell as cell_run, spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                       dev, T_START, control=control)
    bad = forbidden_modules()
    if bad:
        print(f"error: modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": cell.chips, **out["device"]}
    line = {k: out[k] for k in ("correct", "attempted", "failed",
                                "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    earlier = {k: out[k] for k in ("check_s", "frames", "traced_frames",
                                   "marker_lag_ms") if k in out}
    print(json.dumps({**card_line(), **earlier}), flush=True)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
