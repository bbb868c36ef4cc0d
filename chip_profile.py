#!/usr/bin/env python3
"""Where the port's main paths spend their time on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_profile.py

On the MNIST-shaped surrogate (70 000 × 784) it profiles, each time with
the host clock around warm calls and then one more call under
``torch.profiler`` (device time by kernel, the device's busy share of
that call's wall clock, host time by operator):

- a q-means fit, ``QKMeans(n_clusters=10, n_init=10, max_iter=300,
  delta=0.5, true_distance_estimate=False, sketch=0, random_state=0)``,
  once cold and three times warm, with its iterations and kernel
  launches;
- the same fit on ``graded_pair_surrogate(70_000, 784,
  _MNIST_LOW_MARGIN_GRADES, seed=785)``, whose overlapping class pairs
  keep the Lloyd loop running: the kernel's device time in a loop-heavy
  fit;
- one Lloyd step at the slice shape (float32, window 0.5) with R=1 and
  R=10 restarts: device time of each of its kernels;
- a k-NN ``predict`` of the last 10 000 rows by
  ``KNeighborsClassifier(n_neighbors=7)`` fitted on the first 60 000;
- one fold of the 10-fold stratified CV of that classifier on all 70 000
  rows: the host's index copies, ``fit`` and ``score``, as
  ``cross_validate`` runs a fold.

It needs one NVIDIA GPU and exits non-zero without one.
"""

import os
import re
import subprocess
import sys
import time


def profiled(label, fn, torch):
    """Run ``fn`` once under ``torch.profiler`` and print its wall clock,
    the device's busy share of it and the tables by device and host
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type.name == "CUDA")
    print(f"{label} under the profiler: {wall:.4f} s, device busy "
          f"{device_us / 1e3:.3f} ms = {device_us / 1e4 / wall:.2f} % of "
          f"the wall clock", flush=True)
    for prefix in ("lloyd_", "argkmin_"):
        mine = [e for e in events if e.device_type.name == "CUDA"
                and prefix in e.key]
        if mine:
            us = sum(e.self_device_time_total for e in mine)
            names = sorted({re.search(prefix + r"\w+", e.key).group(0)
                            for e in mine})
            print(f"{label}: {prefix}* kernels {us / 1e3:.3f} ms of device "
                  f"time over {sum(e.count for e in mine)} kernel calls "
                  f"({', '.join(names)})", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=25),
          flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=15),
          flush=True)


def lloyd_kernels(X, torch):
    """Device time of each kernel of one Lloyd step at the slice shape
    (70 000 × 784, k=10, window 0.5), averaged over five calls, with one
    and with ten restarts."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    Xc = torch.from_numpy(X).cuda()
    Xc -= Xc.mean(dim=0)
    n = Xc.shape[0]
    w = torch.ones(n, device=Xc.device)
    xsq = torch.sum(Xc * Xc, dim=1)
    C = Xc[torch.from_numpy(np.random.default_rng(0).choice(n, (10, 10)))
           .to(Xc.device)]
    g = torch.Generator(device=Xc.device)
    g.manual_seed(0)
    gum = torch.empty((10, n, 10), device=Xc.device).exponential_(
        generator=g).log_().neg_()
    for r in (1, 10):
        def step():
            return lloyd_step(Xc, w, xsq, C[:r], gumbel=gum[:r], window=0.5)
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            for name in ("lloyd_score", "lloyd_fold", "lloyd_reduce"):
                if name in e.key:
                    per[name] = per.get(name, 0.0) + \
                        e.self_device_time_total / 5 / 1e3
        print(f"lloyd_step R={r} (float32, window 0.5, 70000×784, k=10): "
              f"device ms per call {per}, total {sum(per.values()):.4f}",
              flush=True)


def knn(X, y, torch):
    """Warm predicts and one CV fold of the k-NN path, then each once more
    under the profiler."""
    from sq_learn_tpu_torch.model_selection import StratifiedKFold
    from sq_learn_tpu_torch.models import KNeighborsClassifier
    from sq_learn_tpu_torch.ops.kernels import argkmin

    est = KNeighborsClassifier(n_neighbors=7).fit(X[:60_000], y[:60_000])
    Xte = X[60_000:]
    for label in ("first", "warm", "warm", "warm"):
        argkmin.launches = 0
        t0 = time.perf_counter()
        est.predict(Xte)
        print(f"{label} k-NN predict 10000 rows: "
              f"{time.perf_counter() - t0:.4f} s, kernel launches "
              f"{argkmin.launches}", flush=True)
    profiled("k-NN predict 10000 rows", lambda: est.predict(Xte), torch)

    train, test = next(StratifiedKFold(10).split(X, y))

    def fold():
        # what cross_validate does for one fold
        t0 = time.perf_counter()
        Xtr, ytr = X[train], y[train]
        t1 = time.perf_counter()
        fitted = KNeighborsClassifier(n_neighbors=7).fit(Xtr, ytr)
        t2 = time.perf_counter()
        score = fitted.score(X[test], y[test])
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2, score

    for label in ("warm", "warm"):
        index_s, fit_s, score_s, score = fold()
        print(f"{label} CV fold (63000 train, 7000 test rows): host index "
              f"copy {index_s:.4f} s, fit {fit_s:.4f} s, score "
              f"{score_s:.4f} s, accuracy {score}", flush=True)
    profiled("CV fold", fold, torch)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.datasets import (_MNIST_LOW_MARGIN_GRADES,
                                             graded_pair_surrogate,
                                             synthetic_surrogate)
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    sqt.set_config(device="cuda:0")
    X, y = synthetic_surrogate(70_000, 784, 10, seed=784)
    est = QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
                  true_distance_estimate=False, sketch=0, random_state=0)
    for label in ("cold", "warm", "warm", "warm"):
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        fit = clone(est).fit(X)
        wall = time.perf_counter() - t0
        print(f"{label} fit: {wall:.4f} s, n_iter {fit.n_iter_}, kernel "
              f"launches {lloyd_step.launches}", flush=True)
    profiled("q-means fit", lambda: clone(est).fit(X), torch)
    Xg, yg = graded_pair_surrogate(70_000, 784, _MNIST_LOW_MARGIN_GRADES,
                                   seed=785)
    for label in ("first", "warm", "warm"):
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        fit = clone(est).fit(Xg)
        wall = time.perf_counter() - t0
        print(f"{label} graded fit: {wall:.4f} s, n_iter {fit.n_iter_}, "
              f"kernel launches {lloyd_step.launches}", flush=True)
    profiled("graded q-means fit", lambda: clone(est).fit(Xg), torch)
    lloyd_kernels(X, torch)
    knn(X, y, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
