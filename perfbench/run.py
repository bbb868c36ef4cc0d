"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Without the card(s) the cell asks for, or if
the process holds a module of JAX or of the JAX package once its window has
closed, it exits with a code other than 0 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, where the program and this package live, instead
# of this file's own directory
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))
# a library the program loads must not pull in JAX through flax
os.environ.setdefault("USE_FLAX", "0")
# load from one process with few threads: the host's thread pools at one
# thread each, so that the run's host work contends with nothing of its own
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_name, "1")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             args.trace, started=STARTED)
        harness.finish(result)
    except harness.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except harness.Forbidden as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
