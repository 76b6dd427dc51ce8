"""The precision control of a cell: a run whose check puts the plain
reference computed in bfloat16 in the program's place. Its compared
numbers are the upper readings the limits are set below; the run has to
come out not correct.

    python3 perfbench/tools/control.py --workload <cell> --seed <n> \\
        --seconds <s>

The benchmark's own runs never run it.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(control=True))
