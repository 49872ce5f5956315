"""The readings that a cell's limits are set from, on the card: the
compared numbers of sound runs over many seeds, and of the control
(the plain reference put in the program's place, one precision below
the configuration's) on the first few of them, each at the cell's own
size. One process, one cell, the seeds in turn:

    python3 perfbench/calibrate.py --workload <name> --seconds 4 --seeds 1 2 3 ... --control 3

prints a JSON line a seed: {"seed", "correct", "program": {name: value},
"control": {name: value}, "control_correct"}. The control goes through
the same test as the program (each number finite and within its limit),
and has to come out not correct. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also run the control")
    args = parser.parse_args(argv)
    for i, seed in enumerate(args.seeds):
        with_control = i < args.control
        got = harness.run(args.workload, seed, args.seconds, False, control=with_control)
        row = {"seed": seed, "correct": got[0]["correct"], "attempted": got[0]["attempted"],
               "metrics": {k: v["value"] for k, v in got[0]["metrics"].items()},
               "program": {name: value for name, value, _ in got[1]}}
        if with_control:
            row["control"] = {name: value for name, value, _ in got[2]}
            row["control_correct"] = harness.judged(got[2])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
