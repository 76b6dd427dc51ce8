"""The regen loop's live lanes in a benchmark cell, on the card.

    python3 scripts/regen_live.py --workload rtiow_scene4.regen \\
        [--frames 3] [--seed 1] [--out regen_live.jsonl]

Run from the root of a checkout. Builds the cell's ``Renderer`` as
perfbench/pbench/modes.py does (the configuration's scene, camera and
settings, the traffic's size, spp and sampler), renders its warm-up frames
and then ``--frames`` timed frames, then ``--frames`` more in which the
loop's state is read after every block of iterations. A lane is live while
its ``sample_i`` is below spp; a finished lane has traced all its samples.

One JSON line a frame: ``timed``: frame ms and segments (``stats_log``);
``blocks``: the segments, the iterations run (the blocks' sizes summed),
``live_share`` = segments / (lanes x iterations), its complement
``finished_share``, the live lanes after each block (a host read of
``sample_i`` between replays, so these frames are not timed), the growth
of the ``regen.lane_iterations`` count over the frame and the share of
those lane-iterations the kernels skipped, 1 - segments / lane-iterations,
and the growth of the ``rt_hit_resolve.skip`` and
``rt_hit_resolve_blocked.skip`` counts summed (the K5 / K6 launches that
skipped finished lanes). The counts are the program's (utils/trace.py);
on an older tree, which kept them as module counters
(``integrator.LANE_ITERATIONS``, ``intersect_cuda.SKIP_LAUNCHES``), those
are read, and null where the tree has neither. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counts(trace, integrator, intersect_cuda):
    """(lane-iterations, skipping hit launches) so far: the program counts,
    else an older tree's module counters, else None for each."""
    if hasattr(trace, "counts"):
        c = trace.counts()
        return (c["regen.lane_iterations"], c["rt_hit_resolve.skip"]
                + c["rt_hit_resolve_blocked.skip"])
    return (getattr(integrator, "LANE_ITERATIONS", None),
            getattr(intersect_cuda, "SKIP_LAUNCHES", None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "perfbench")]
    import torch
    from pbench import modes, spec

    from raytracer_tpu_torch.ops import integrator, intersect_cuda
    from raytracer_tpu_torch.runtime.renderer import Renderer
    from raytracer_tpu_torch.utils import trace

    cell = spec.load(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    scene, use_sky = modes.program_scene(cell, dev)
    settings = modes.settings_of(cell, use_sky)
    r = Renderer(scene, modes.camera_of(cell, cell.config["camera"]),
                 settings, seed=args.seed & 0xFFFFFFFF, device=dev)
    lanes = cell.traffic["width"] * cell.traffic["height"]
    spp = settings.rays_per_pixel
    for _ in range(cell.traffic["warmup_frames"]):
        r.render_frame(block=True)

    lines = []
    for _ in range(args.frames):
        r.render_frame(block=True)
        rec = r.stats_log[-1]
        lines.append({"workload": args.workload, "frame": rec["frame"],
                      "timed": {"frame_ms": rec["frame_ms"],
                                "segments": rec["segments"]}})

    blocks = []
    step = integrator._RegenGraphs.step

    def counted(self, it, k):
        step(self, it, k)
        live = int((self.st["sample_i"] < spp).sum())
        blocks.append((it + k, live))
    integrator._RegenGraphs.step = counted
    for _ in range(args.frames):
        blocks.clear()
        before, skips = _counts(trace, integrator, intersect_cuda)
        t = time.perf_counter()
        r.render_frame(block=True)
        wall = time.perf_counter() - t
        segs = r.stats_log[-1]["segments"]
        iters = blocks[-1][0] if blocks else 0
        after, skips_after = _counts(trace, integrator, intersect_cuda)
        grown = None if before is None else after - before
        live = segs / (lanes * iters) if iters else None
        lines.append({"workload": args.workload, "frame": r.frame_num,
                      "blocks": {
                          "segments": segs, "iterations": iters,
                          "lanes": lanes, "live_share": live,
                          "finished_share": None if live is None
                          else 1.0 - live,
                          "live_after_block": blocks[:],
                          "lane_iterations": grown,
                          "skipped_share": 1.0 - segs / grown
                          if grown else None,
                          "skip_launches": None if skips is None
                          else skips_after - skips,
                          "wall_ms_with_reads": wall * 1e3}})
    integrator._RegenGraphs.step = step
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
