"""One run of one cell: set-up, the measured window, the check, and the
result line's numbers.

End-to-end metrics come from the host clock over the whole window; the
per-layer metrics of a traced run come from their readers in
``metrics/``, which read the window's spans and its device trace and
return None where they find nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import check, modes, spec, stats


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    frame_s: list          # seconds of each frame of the window
    spans: dict            # host span name -> seconds of each frame
    trace: object          # profile.Trace of a traced window, else None


END_TO_END = {
    "setup_s": lambda t, win: win.setup_s,
    "msamples_per_s": lambda t, win: stats.rate(
        t["width"] * t["height"] * t["spp"] * win.frames, win.window_s) / 1e6,
    "frame_ms_p95": lambda t, win: stats.percentile(
        [s * 1e3 for s in win.frame_s], 95),
}


def end_to_end(cell: spec.Cell, win) -> dict:
    """The cell's end-to-end metrics, named as BENCHMARK.json names them."""
    return {m["name"]: {"value": END_TO_END[m["name"]](cell.traffic, win),
                        "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell: spec.Cell, win) -> dict:
    ctx = Context(win.frame_s, win.spans, win.trace)
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float, control: bool = False) -> dict:
    """Run the cell; returns the result line's fields and the checks."""
    unknown = [m["name"] for m in cell.end_to_end
               if m["name"] not in END_TO_END]
    if unknown:
        raise ValueError(f"the harness takes no end-to-end metric {unknown}")
    check.validate(cell)
    win = modes.driver(cell)(cell, seed, seconds, trace, dev, t_start)
    metrics = per_layer(cell, win) if trace else end_to_end(cell, win)
    device = {"memory_peak_bytes": win.memory_peak}
    if trace:
        if dev.type == "cuda" and not win.trace.frames:
            raise RuntimeError("the profiler recorded no whole frame")
        device.update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
    # the program's state goes before the reference runs on the device
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check.CHECKS[cell.traffic["mode"]](cell, win, seed, dev,
                                                  control=control)
    correct, rows = check.verdict(numbers, cell.check["limits"])
    out = {"correct": correct, "attempted": win.frames, "failed": 0,
           "metrics": metrics, "device": device, "checks": rows,
           "check_s": time.perf_counter() - t0, "frames": win.frames}
    if trace:
        from . import profile
        out["breakdown"] = profile.breakdown(win.trace)
        out["traced_frames"] = [win.trace.frames, win.trace.traced]
        out["marker_lag_ms"] = win.trace.lag_ms
    return out
