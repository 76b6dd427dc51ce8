"""A traced run of one cell with the port's span recorder on
(raytracer_tpu_torch/utils/trace.py): the benchmark's traced run as
``run.py --trace 1`` makes it, the recorder enabled over the measured
window, and after its lines one more, ``{"spans": ...}``: the counted
frames' device idle and host time by the innermost span, and the spans'
numbers a frame (``pbench/spans.py``).

    python3 perfbench/tools/spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <spans.jsonl>]

``--out`` also writes the window's spans, one JSON object each. In its
own process it wraps ``pbench.modes._measure`` (the recorder on over the
window) and ``pbench.profile.reduce`` (the window's profiler and marker
launches, handed to ``pbench.spans.reduce`` too); what the harness
computes is unchanged. The benchmark's own runs never run it, and never
enable the recorder.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import run  # noqa: E402
from pbench import modes, profile, spans  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args, rest = ap.parse_known_args()
    from raytracer_tpu_torch.utils import trace

    measure, reduce = modes._measure, profile.reduce
    got = {}

    def traced_measure(*a, **kw):
        trace.enable()
        try:
            return measure(*a, **kw)
        finally:
            trace.enable(False)

    def traced_reduce(prof, launches, phases):
        recorded = trace.take()
        if args.out:
            trace.write_jsonl(args.out, recorded)
        got.update(spans.reduce(
            prof, launches, phases,
            [(n, s * 1e-9, e * 1e-9, p, f) for n, s, e, p, f in recorded]))
        return reduce(prof, launches, phases)

    modes._measure, profile.reduce = traced_measure, traced_reduce
    rc = run.main(rest + ["--trace", "1"])
    print(json.dumps({"spans": got}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
