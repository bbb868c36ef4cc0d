"""Tomography-error histogram experiment, on the port.

The port's counterpart of ``examples/tomography_histogram.py`` (the
working equivalent of the reference's ``sklearn/Sheet1.py``): estimate a
random unit vector by vector-state tomography at a given δ, over many
trials in one batched call (every trial a row of one ``real_tomography``
call, all drawn from one explicit generator on the device), and
histogram the errors, in the norm whose guarantee N was sized for,
against δ.

Run: python examples_torch/tomography_histogram.py [--dim 784]
     [--delta 0.1] [--trials 64] [--save hist.png] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device, synchronize  # noqa: E402

import argparse  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from sq_learn_tpu_torch.ops.quantum import real_tomography  # noqa: E402
from sq_learn_tpu_torch.ops.quantum.tomography import (  # noqa: E402
    tomography_n_measurements)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=784)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--norm", choices=["L2", "inf"], default="L2")
    ap.add_argument("--save", default=None, help="write a histogram PNG")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    with on_device(args.device) as device:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
        v = torch.randn(args.dim, generator=generator, device=device)
        v = v / torch.linalg.norm(v)

        N = tomography_n_measurements(args.dim, args.delta, norm=args.norm)
        print(f"dim={args.dim} delta={args.delta} -> N={N} "
              f"measurements/trial")

        t0 = time.perf_counter()
        estimates = real_tomography(
            generator, v.expand(args.trials, args.dim), delta=args.delta,
            norm=args.norm)
        diff = estimates - v[None, :]
        # measure the error in the norm whose guarantee N was sized for
        if args.norm == "L2":
            errors = torch.linalg.norm(diff, dim=1)
        else:
            errors = torch.amax(diff.abs(), dim=1)
        synchronize(device)
        wall = time.perf_counter() - t0
        errors = errors.cpu().numpy()

    within = float((errors <= args.delta).mean())
    print(f"{args.trials} trials in {wall:.2f}s: "
          f"mean {args.norm} err {errors.mean():.4f}, "
          f"max {errors.max():.4f}, P(err <= delta) = {within:.2%}")

    if args.save:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.hist(errors, bins=30)
        plt.axvline(args.delta, color="red", linestyle="--",
                    label=f"delta={args.delta}")
        plt.xlabel(f"{args.norm} tomography error")
        plt.ylabel("trials")
        plt.legend()
        plt.savefig(args.save, dpi=120)
        print(f"histogram -> {args.save}")
    return {"N": N, "trials": args.trials, "wall_s": wall,
            "mean_err": float(errors.mean()), "max_err": float(errors.max()),
            "within": within, "errors": errors.tolist()}


if __name__ == "__main__":
    main()
