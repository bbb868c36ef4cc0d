"""The readings that set a cell's limits: the compared numbers of the
program over many seeds, or of the control (the plain reference, its
products in TF32, in the program's place), in one process so that set-up
is paid once for the kernels.

    python3 perfbench/readings.py --workload <cell> --impl program \\
        --seconds 5 --seeds 1 2 3 ...

Prints one JSON line per seed: the seed, ``correct`` under the limits in
force, and each number the judge read (the compared ones and those, such
as ``optimum_gap`` under ``--optimum``, that no run compares). The
benchmark's own runs never run this. ``--impl worst_restart`` runs a q-means
cell's plain float32 reference keeping its worst restart, a planted fault.
"""

import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--impl", required=True,
                        choices=("program", "control", "worst_restart"))
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--optimum", action="store_true",
                        help="q-means: also read optimum_gap against a "
                             "float64 reference fit of each sampled fit")
    args = parser.parse_args(argv)
    traffic = {"judge_optimum": True} if args.optimum else None

    from perfbench import harness

    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = {}
        result = harness.run(args.workload, seed, args.seconds, 0,
                             impl=args.impl, traffic_overrides=traffic,
                             judged_out=numbers)
        print(json.dumps({
            "seed": seed, "impl": args.impl, "correct": result["correct"],
            "attempted": result["attempted"],
            "seconds": time.perf_counter() - t0,
            "numbers": numbers}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
