"""Run one cell of the benchmark once and print its result line:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(also ``python -m perfbench.run``), from the root of a checkout."""

import pathlib
import sys

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from perfbench.harness import main

    sys.exit(main())
