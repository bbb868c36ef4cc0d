#!/usr/bin/env python3
"""Where a main-path q-means fit of the port spends its time on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_profile.py

It fits ``QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
true_distance_estimate=False, sketch=0, random_state=0)`` on the
MNIST-shaped surrogate (70 000 × 784) once cold and three times warm
(host clock around each call, with its iterations and kernel launches),
then once more under ``torch.profiler``: device time by kernel, the
device's busy share of that fit's wall clock, and host time by operator.
It needs one NVIDIA GPU and exits non-zero without one.
"""

import os
import subprocess
import sys
import time


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.datasets import synthetic_surrogate
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    sqt.set_config(device="cuda:0")
    X, _ = synthetic_surrogate(70_000, 784, 10, seed=784)
    est = QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
                  true_distance_estimate=False, sketch=0, random_state=0)
    for label in ("cold", "warm", "warm", "warm"):
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        fit = clone(est).fit(X)
        wall = time.perf_counter() - t0
        print(f"{label} fit: {wall:.4f} s, n_iter {fit.n_iter_}, kernel "
              f"launches {lloyd_step.launches}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clone(est).fit(X)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type.name == "CUDA")
    print(f"fit under the profiler: {wall:.4f} s, device busy "
          f"{device_us / 1e3:.3f} ms = {device_us / 1e4 / wall:.2f} % of "
          f"the wall clock", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=25),
          flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=15),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
