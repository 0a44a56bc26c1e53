"""Readings of the comparison behind `correct`, for setting its limits:
for each seed, one run of a cell's set-up and window on the card, then
each number compared against the plain reference (the sound reading)
and against the reference in the nearest precision below the
configuration's float32, bfloat16 (the control).

    python3 rgkbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--controls N] [--out FILE]

The first `--controls` seeds (all by default) read the control and the
faults too.  Prints one JSON line a seed, with the seconds its
comparisons took; with --out also appends them to FILE.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from rgkbench import harness

    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = len(seeds) if args.controls is None else args.controls
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        line = dict(workload=args.workload, seed=seed,
                    **harness.readings(args.workload, seed, args.seconds,
                                       dev, control=i < controls))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, _ROOT)
    sys.exit(main())
