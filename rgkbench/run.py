"""Run one cell of the benchmark once and print its result line.

    python3 rgkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: loads and warms up the cell, measures for
`--seconds`, compares what the window produced with the plain
reference, and prints one JSON line (module doc of `harness.py`).
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, _ROOT)
    from rgkbench import harness

    sys.exit(harness.main(started=harness.process_start()))
