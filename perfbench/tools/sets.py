"""Runs of one cell, each in its own process, one after the other: the
benchmark's command with each seed given, its result lines kept.

    python3 perfbench/tools/sets.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--trace 1] [--control] --out <file.jsonl>

Each line of ``--out`` holds a run's seed, exit code, wall seconds, its
last output line (the result) and its last lines on standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    script = os.path.join(BENCH, "tools", "control.py") if args.control \
        else os.path.join(BENCH, "run.py")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, script, "--workload", args.workload, "--seed",
             str(seed), "--seconds", str(args.seconds), "--trace",
             str(args.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            result = None
        rec = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "wall_s": wall, "trace": args.trace, "control": args.control,
               "earlier": lines[:-1], "result": result,
               "stderr": p.stderr.strip().splitlines()[-12:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = {k: v["value"] for k, v in (result or {}).get(
            "metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": wall,
                          "correct": (result or {}).get("correct"),
                          "metrics": short,
                          "checks": (result or {}).get("checks")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
