"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; ``perfbench/README.md`` says what the run
does. The last line of standard output is the result (one JSON object);
the numbers that decided ``correct`` are also the last lines of standard
error. Without a CUDA device, or with fewer than the cell asks for, the
run exits 1 and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    from perfbench import bench
    return bench.main(args.workload, args.seed, args.seconds,
                      bool(args.trace), started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
