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
- one k-NN search at the predict shape (10 000 queries, 60 000 × 784
  train rows, k=7): device time of each of its kernels;
- a k-NN ``predict`` of the last 10 000 rows by
  ``KNeighborsClassifier(n_neighbors=7)`` fitted on the first 60 000;
- one fold of the 10-fold stratified CV of that classifier on all 70 000
  rows: the host's index copies, ``fit`` and ``score``, as
  ``cross_validate`` runs a fold;
- the qPCA trial (``examples/mnist_trial.py`` at ``--subsample 0``):
  ``QPCA(n_components=61, svd_solver="full", random_state=0).fit(X,
  estimate_all=True, eps=0.4, delta=0.4, theta_major=1e-9,
  true_tomography=False)``, cold and warm, then under the profiler; its
  steps one by one in device ms (CUDA events, median of 5): upload,
  mean and centering, Gram, the 784 × 784 ``eigh`` (float64, as the fit
  runs it, beside float32 with each one's largest relative eigenvalue
  error against a float64 Gram), U block, μ(A) sketch (beside the exact
  μ sweep over all rows, which the fit does not run), the consistent-PE
  and tomography draws (Gaussian, and true tomography's multinomial
  tree), the fit's host fetches (beside the upload of U's block from
  numpy, which the fit does not make) and host syncs; the binary searches the
  trial does not run (spectral norm, σ_min, θ) with their wall clocks and
  host syncs; then the quantum transform and one CV fold of 7-NN at
  width 61;
- q-means at the reference's defaults (``QKMeans(n_clusters=10,
  n_init=10, max_iter=300, delta=0.5, random_state=0)``: the IPE E-step,
  the sketched σ_min/η statistics), cold and warm, under the profiler,
  its host syncs, and its steps one by one in device ms: upload,
  prestats with the sketch, init, one IPE E-step of the 10 restarts (each
  iteration runs one, the final re-evaluation two), partial sums and
  relocation; the σ_min of the exact route, ``eigvalsh`` of the 784 × 784
  Gram in float32 against float64, with each one's error against a
  float64 Gram;
- δ-means with true tomography of the centers every iteration
  (``intermediate_error=True``): the fit and one tomography of the 10 × 10
  centers at δ/2 (true and Gaussian);
- QLSSVC on classes 0 and 1 of the surrogate (8 000 training rows): the
  fit and predict of the linear and rbf kernels, and the ``eigh`` of the
  8 001 × 8 001 saddle matrix F in float32 against float64, with each
  one's largest relative error on the singular values and on ``cond_``;
- one fit of the δ-sweep (BASELINE #5: the CICIDS surrogate, 50 000 ×
  78, standardized on the card; ``QKMeans(n_clusters=6, n_init=10,
  delta=0.5, true_distance_estimate=False, random_state=0)``), cold and
  warm, under the profiler, its host syncs, and its steps in device ms:
  the scaler, prestats with the sketch, init, the Gumbel draw, one Lloyd
  step of the 10 restarts, relocation and update, the final E-step; then
  the same fit with obs on (``obs.enable(<file>)``): warm wall clock,
  under the profiler, its host syncs beside the obs-off count, the
  records it writes, and the audit's own pieces alone (the fit's
  δ-window replay on 256 rows, the sketch's exact-μ audit);
- one fold of the error-budget grid search (scale → QPCA(61) → 7-NN,
  56 000 training and 14 000 test rows): the host's index copies, the
  pipeline's fit and score, then under the profiler;
- one mini-batch q-means fit (``MiniBatchQKMeans(n_clusters=10,
  batch_size=1024, delta=0.5, random_state=0)`` at 70 000 × 784), cold
  and warm with its steps per second, under the profiler, its host syncs,
  and in device ms: the upload, one step, one epoch, the init selection
  and the final assignment of all rows;
- the streamed ingest: ``streamed_resident_put`` of the surrogate (2
  tiles at the default cap, 14 at 16 MiB) beside the pageable upload,
  BASELINE #3's q-means fit (which streams its 219.5 MB under 'auto')
  beside the same fit with the cap lifted (one pageable upload), and
  ``QPCA(61, svd_solver='full')`` streamed beside monolithic, each in
  turns, warm wall clocks; then each under the profiler, read from its
  trace: the host→device copies' device time and streams, the kernels',
  the share of copy time a kernel overlaps, and the device's busy share;
  last BASELINE #4's ``TruncatedSVD(10, n_iter=5, random_state=0)`` on
  the covertype surrogate with ``ingest='streamed'`` at 16 MiB tiles
  (its first fit timed alone) beside the monolithic fit, in turns, the
  streamed one under the profiler, and the host's float64 total variance
  that the streamed fit takes.
  ``python3 chip_profile.py --streaming`` runs this part alone.
- the out-of-core plane (``python3 chip_profile.py --oocore`` runs it
  alone): the store S1 of ``chip_smoke.py`` (``create_synthetic_store``,
  1 000 000 × 784, 374 shards of 8 MiB, 3.14 GB) and its mini-batch fit
  (``MiniBatchQKMeans(n_clusters=10, batch_size=1024, max_iter=2,
  max_no_improvement=None, delta=0.5, random_state=0)``) taken apart:
  the fit and its labelling pass warm; one epoch's host batch walk with
  the CRC off and on, at readahead depth 0 and 2; ``zlib.crc32`` alone
  over every shard; the uploads of one epoch's batches through the pinned
  ring; one mini-batch step and one labelling Lloyd launch (1024 × 784,
  k=10, R=1) in device ms; then one epoch of the fit and the labelling
  pass under the profiler (device busy share, kernels, host operators).

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


def argkmin_kernels(X, torch):
    """Device time of each kernel of one k-NN search at the predict shape
    (queries X[60000:], train rows X[:60000], k=7), averaged over five
    calls."""
    from torch.profiler import ProfilerActivity, profile

    from sq_learn_tpu_torch.ops.kernels import argkmin

    Xd = torch.from_numpy(X).cuda()
    T, Q = Xd[:60_000].contiguous(), Xd[60_000:].contiguous()
    tsq = torch.sum(T * T, dim=1)
    argkmin(T, tsq, Q, 7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            argkmin(T, tsq, Q, 7)
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        name = re.search(r"argkmin_\w+", e.key)
        if name and e.device_type.name == "CUDA":
            per[name.group(0)] = per.get(name.group(0), 0.0) + \
                e.self_device_time_total / 5 / 1e3
    print(f"argkmin (10000 × 60000 × 784, k=7): device ms per call {per}, "
          f"total {sum(per.values()):.4f}", flush=True)


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


def events_ms(fn, torch, reps=5):
    """Median ms of ``fn`` between two CUDA events, after one warm-up."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def count_syncs(fn, torch):
    """Run ``fn`` with torch's CUDA sync debug mode set to warn; returns
    its result and the number of operations that made the host wait for
    the device (the warnings the mode raises)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def qpca_trial(X, y, torch):
    """The qPCA trial's fit, step by step and whole, its transform and one
    CV fold at width 61."""
    import numpy as np

    from sq_learn_tpu_torch.model_selection import StratifiedKFold
    from sq_learn_tpu_torch.models import QPCA, KNeighborsClassifier
    from sq_learn_tpu_torch.models.qpca import singular_value_estimates
    from sq_learn_tpu_torch.ops.kernels import argkmin
    from sq_learn_tpu_torch.ops.linalg import gram_spectrum, svd_flip_v
    from sq_learn_tpu_torch.ops.quantum import tomography
    from sq_learn_tpu_torch.ops.quantum.norms import _mu_grid, _search_grid
    from sq_learn_tpu_torch.sketch import engine
    from sq_learn_tpu_torch.utils.validation import check_array

    k, dev = 61, torch.device("cuda:0")
    fit_kw = dict(estimate_all=True, eps=0.4, delta=0.4, theta_major=1e-9,
                  true_tomography=False)

    def fit():
        return QPCA(n_components=k, svd_solver="full",
                    random_state=0).fit(X, **fit_kw)

    for label in ("cold", "warm", "warm", "warm"):
        t0 = time.perf_counter()
        pca = fit()
        torch.cuda.synchronize()
        print(f"{label} qPCA trial fit: {time.perf_counter() - t0:.4f} s, "
              f"topk {pca.topk}", flush=True)
    profiled("qPCA trial fit", fit, torch)

    # the fit's steps, one by one
    Xd = check_array(X, device=dev)
    mean = torch.mean(Xd, dim=0)
    Xc = Xd - mean
    G = Xc.T @ Xc
    S, V, safe = gram_spectrum(G)
    _, Vt = svd_flip_v(None, V.T)
    n = X.shape[0]
    X64 = Xd.double()
    X64 -= X64.mean(dim=0)
    ev64 = torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:k]
    del X64
    for name, evals in (
            ("float32 (cuSOLVER)", torch.linalg.eigvalsh(G).flip(0)[:k]),
            ("float64 of the float32 Gram", S[:k].double() ** 2)):
        rel = float(((evals.double() - ev64).abs() / ev64).max())
        print(f"784 × 784 eigh in {name}: largest relative error of the "
              f"first {k} eigenvalues against a float64 Gram {rel:.4e}",
              flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    grid = _search_grid(0.0, 1.0, 0.1)
    right = Vt[:k].contiguous()
    left = ((Xc @ right.T) / safe[None, :k]).T.contiguous()
    left_np = left.cpu().numpy()
    muA = pca.muA
    steps = {
        "upload (check_array, pageable)": lambda: check_array(X, device=dev),
        "mean and centering": lambda: Xd - torch.mean(Xd, dim=0),
        "Gram Xcᵀ·Xc (float32)": lambda: Xc.T @ Xc,
        "eigh 784 × 784 float64 (the fit's)": lambda: gram_spectrum(G),
        "eigh 784 × 784 float32 (not used)": lambda: torch.linalg.eigh(G),
        "U block Xc·Vtᵀ (61 columns)": lambda: (Xc @ right.T) / safe[:k],
        "μ(A) sketch (4096 rows, 11-point grid)": lambda: engine.spectral_stats(
            Xc, grid, sketch=4096, with_sigma=False,
            rng=np.random.default_rng(0)),
        "exact μ(A) over all 70000 rows, 11-point grid (not used)":
            lambda: _mu_grid(Xc, grid),
        "consistent PE of 61 σ": lambda: singular_value_estimates(
            g, S[:k], muA, 0.4 / muA, X.shape[1]),
        "Gaussian tomography, right 61 × 784": lambda: tomography(
            g, right, 0.4, true_tomography=False),
        "Gaussian tomography, left 61 × 70000": lambda: tomography(
            g, left, 0.4, true_tomography=False),
        "true tomography, right 61 × 784": lambda: tomography(
            g, right, 0.4),
        "true tomography, left 61 × 70000": lambda: tomography(g, left, 0.4),
        "host fetches (left_sv and its estimate, 2 × 61 × 70000)":
            lambda: (left.cpu(), left.cpu()),
        "left block back from numpy, 61 × 70000 (the fit keeps it on the "
        "card; not used)": lambda: torch.as_tensor(left_np, device=dev),
    }
    total = 0.0
    for name, fn in steps.items():
        ms = events_ms(fn, torch)
        if "not used" not in name and "true tomography" not in name:
            total += ms
        print(f"qPCA fit step, {name}: {ms:.4f} device ms", flush=True)
    print(f"qPCA fit steps on the trial's path: {total:.4f} ms in all "
          f"(the Gaussian route; true tomography is the smoke's second "
          f"extraction)", flush=True)
    _, syncs = count_syncs(fit, torch)
    print(f"qPCA trial fit: {syncs} host syncs (CUDA sync debug mode)",
          flush=True)

    # the binary searches the trial does not run, at its shape: wall clock
    # and host syncs (the bracket searches fetch once at the end, the θ
    # search once per iteration)
    # the retained mass of the first 5 components: a step of the kept
    # spectrum, where the θ search converges
    S = pca.singular_values_.astype(np.float64)
    p_step = float(np.sum(S[:5] ** 2) / np.sum(S**2))
    searches = {
        f"spectral-norm search (ε = 0.4, δ = 0.01, 61 σ; exact "
        f"{pca.spectral_norm})": lambda: pca.spectral_norm_estimation(
            0.4, 0.01),
        f"σ_min search (ε = 0.4, δ = 0.001, 784 σ; exact "
        f"{float(pca.all_singular_values_[-1])})":
            lambda: pca.condition_number_estimation(0.4, 0.001),
        f"θ search (ε = 0.4, η = 0.05, p = {p_step:.4f}; σ₅ "
        f"{float(S[4])}, σ₆ {float(S[5])})":
            lambda: pca.estimate_theta(epsilon=0.4, eta=0.05, p=p_step),
    }
    for name, fn in searches.items():
        t0 = time.perf_counter()
        try:
            out, syncs = count_syncs(fn, torch)
        except ValueError as err:  # the θ search found no θ this draw
            out, syncs = f"raised {err}", "?"
        print(f"qPCA {name}: {time.perf_counter() - t0:.4f} s, {syncs} "
              f"host syncs, result {out}", flush=True)

    def quantum_transform():
        return pca.transform(X, classic_transform=False,
                             use_classical_components=False)

    for label in ("warm", "warm"):
        t0 = time.perf_counter()
        Xq = quantum_transform()
        torch.cuda.synchronize()
        print(f"{label} quantum transform 70000 × 784 → 61: "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
    profiled("quantum transform", quantum_transform, torch)

    Xq = Xq.cpu().numpy()  # cross_validate fetches its input to the host
    train, test = next(StratifiedKFold(10).split(Xq, y))

    def fold():
        t0 = time.perf_counter()
        Xtr, ytr = Xq[train], y[train]
        t1 = time.perf_counter()
        fitted = KNeighborsClassifier(n_neighbors=7).fit(Xtr, ytr)
        t2 = time.perf_counter()
        score = fitted.score(Xq[test], y[test])
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2, score

    for label in ("warm", "warm"):
        argkmin.launches = 0
        index_s, fit_s, score_s, score = fold()
        print(f"{label} CV fold at width 61 (63000 train, 7000 test rows): "
              f"host index copy {index_s:.4f} s, fit {fit_s:.4f} s, score "
              f"{score_s:.4f} s, accuracy {score}, argkmin launches "
              f"{argkmin.launches}", flush=True)
    profiled("CV fold at width 61", fold, torch)


def qkmeans_quantum(X, torch):
    """q-means at the reference's defaults (IPE, sketch), step by step and
    whole; then δ-means with true tomography of the centers."""
    import numpy as np

    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.models import qkmeans as tqk
    from sq_learn_tpu_torch.ops.kernels import lloyd_step
    from sq_learn_tpu_torch.parallel.init import resolve_init_subsample
    from sq_learn_tpu_torch.sketch import engine
    from sq_learn_tpu_torch.utils import as_generator
    from sq_learn_tpu_torch.utils.validation import check_array

    dev = torch.device("cuda:0")
    est = QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
                  random_state=0)
    for label in ("cold", "warm", "warm"):
        t0 = time.perf_counter()
        fit = clone(est).fit(X)
        print(f"{label} IPE q-means fit: {time.perf_counter() - t0:.4f} s, "
              f"n_iter {fit.n_iter_}, κ {fit.condition_number_}", flush=True)
    profiled("IPE q-means fit", lambda: clone(est).fit(X), torch)
    _, syncs = count_syncs(lambda: clone(est).fit(X), torch)
    print(f"IPE q-means fit: {syncs} host syncs (CUDA sync debug mode)",
          flush=True)

    n = X.shape[0]
    Xd = check_array(X, device=dev)
    w = torch.ones(n, device=dev)
    idx = torch.as_tensor(engine.sample_indices(
        np.random.default_rng([0, engine.SKETCH_SEED]), n, 4096), device=dev)
    stats = tqk.fit_prestats(Xd, quantum=True, mu_grid=tqk.MU_GRID,
                             sketch_idx=idx)
    gen = as_generator(0, dev)
    sub = resolve_init_subsample(n, 10, "auto")
    c0 = tqk._restart_inits(gen, stats["Xc"], w, stats["xsq"], n_init=10,
                            init="k-means++", n_clusters=10,
                            init_subsample=sub)
    labels, _, min_d2 = tqk.e_step(gen, stats["Xc"], w, c0, stats["xsq"],
                                   delta=0.5, mode="ipe")

    def partials():
        sums, counts = tqk._cluster_partials(stats["Xc"], w, labels, 10)
        return tqk.relocate_empty_clusters(stats["Xc"], w, labels, min_d2,
                                           sums, counts)

    steps = {
        "upload (check_array, pageable)": lambda: check_array(X, device=dev),
        "prestats with the sketch (4096 rows)": lambda: tqk.fit_prestats(
            Xd, quantum=True, mu_grid=tqk.MU_GRID, sketch_idx=idx),
        "prestats exact (sketch=0; not used)": lambda: tqk.fit_prestats(
            Xd, quantum=True, mu_grid=tqk.MU_GRID),
        "init (k-means++, 10 restarts)": lambda: tqk._restart_inits(
            gen, stats["Xc"], w, stats["xsq"], n_init=10, init="k-means++",
            n_clusters=10, init_subsample=sub),
        "IPE E-step, 10 restarts (one per iteration, two at the end)":
            lambda: tqk.e_step(gen, stats["Xc"], w, c0, stats["xsq"],
                               delta=0.5, mode="ipe"),
        "partial sums and relocation": partials,
    }
    for name, fn in steps.items():
        print(f"IPE q-means step, {name}: {events_ms(fn, torch):.4f} device "
              f"ms", flush=True)

    # σ_min of the exact route: the 784 × 784 Gram's λ_min both ways
    G = Xd.T @ Xd
    X64 = Xd.double()
    lam64 = float(torch.linalg.eigvalsh(X64.T @ X64)[0])
    del X64
    for name, fn in (("float32", lambda: torch.linalg.eigvalsh(G)),
                     ("float64 (the fit's)",
                      lambda: torch.linalg.eigvalsh(G.double()))):
        lam = float(fn()[0])
        print(f"σ_min route, eigvalsh 784 × 784 in {name}: "
              f"{events_ms(fn, torch):.4f} device ms, λ_min {lam}, κ "
              f"relative error against a float64 Gram "
              f"{abs((lam64 / lam) ** 0.5 - 1):.4e}", flush=True)

    # δ-means with true tomography of the centers
    est_b = QKMeans(n_clusters=10, n_init=10, delta=0.5,
                    true_distance_estimate=False, intermediate_error=True,
                    random_state=0)
    for label in ("cold", "warm", "warm"):
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        fit = clone(est_b).fit(X)
        print(f"{label} tomography δ-means fit: "
              f"{time.perf_counter() - t0:.4f} s, n_iter {fit.n_iter_}, "
              f"lloyd_step launches {lloyd_step.launches}", flush=True)
    profiled("tomography δ-means fit", lambda: clone(est_b).fit(X), torch)
    for name, true in (("true", True), ("Gaussian", False)):
        ms = events_ms(lambda: tqk.center_tomography(
            gen, c0, 0.25, true_tomography=true), torch)
        print(f"tomography of the 10 × 10 centers at δ/2 = 0.25, {name}: "
              f"{ms:.4f} device ms per iteration", flush=True)


def qlssvc(X, y, torch):
    """QLSSVC fits and the eigh of F at 8 001² both ways."""
    import numpy as np

    from sq_learn_tpu_torch.models import QLSSVC
    from sq_learn_tpu_torch.models.qlssvc import saddle_matrix

    rows = np.flatnonzero(y <= 1)
    rows = rows[np.random.default_rng(0).permutation(len(rows))]
    tr, te = rows[:8000], rows[8000:10000]
    ypm = np.where(y == 0, 1.0, -1.0)
    for kernel, error_type in (("linear", "absolute"), ("rbf", "relative")):
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            est = QLSSVC(kernel=kernel, error_type=error_type,
                         random_state=0).fit(X[tr], ypm[tr])
            fit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            est.predict(X[te])
            print(f"{label} QLSSVC({kernel!r}, {error_type!r}) 8000×784: "
                  f"fit {fit_s:.4f} s, predict 2000 rows "
                  f"{time.perf_counter() - t0:.4f} s", flush=True)
        F = saddle_matrix(est.get_kernel(est.X_), est.penalty)
        s64 = torch.linalg.eigvalsh(F.double()).abs().sort(
            descending=True).values
        for name, fn in (("float32", lambda: torch.linalg.eigh(F)),
                         ("float64 (the fit's)",
                          lambda: torch.linalg.eigh(F.double()))):
            s = fn()[0].double().abs().sort(descending=True).values
            err = float(((s - s64).abs() / s64).max())
            cond_err = abs(float(s[0] / s[-1]) / float(s64[0] / s64[-1]) - 1)
            print(f"QLSSVC {kernel}: eigh of F 8001 × 8001 in {name}: "
                  f"{events_ms(fn, torch, reps=3):.4f} device ms, largest "
                  f"relative error of |λ| {err:.4e}, of cond_ "
                  f"{cond_err:.4e}", flush=True)
        del F


def delta_sweep_fit(torch):
    """One fit of the δ-sweep (BASELINE #5) at width 78, δ=0.5, whole and
    step by step."""
    import warnings

    import numpy as np

    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.datasets import load_cicids
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.models import qkmeans as tqk
    from sq_learn_tpu_torch.ops.kernels import lloyd_step
    from sq_learn_tpu_torch.parallel.init import resolve_init_subsample
    from sq_learn_tpu_torch.preprocessing import StandardScaler
    from sq_learn_tpu_torch.sketch import engine
    from sq_learn_tpu_torch.utils import as_generator

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X, _, _ = load_cicids(n_samples=50_000)
    dev = torch.device("cuda:0")
    print(f"δ-sweep: StandardScaler on the card "
          f"{events_ms(lambda: StandardScaler().fit_transform(X), torch):.4f}"
          f" device ms", flush=True)
    Xs = StandardScaler().fit_transform(X)
    est = QKMeans(n_clusters=6, n_init=10, delta=0.5,
                  true_distance_estimate=False, random_state=0)
    for label in ("cold", "warm", "warm"):
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        fit = clone(est).fit(Xs)
        print(f"{label} δ-sweep fit (δ=0.5, 50000×78, k=6): "
              f"{time.perf_counter() - t0:.4f} s, n_iter {fit.n_iter_}, "
              f"lloyd_step launches {lloyd_step.launches}", flush=True)
    profiled("δ-sweep fit", lambda: clone(est).fit(Xs), torch)
    _, syncs = count_syncs(lambda: clone(est).fit(Xs), torch)
    print(f"δ-sweep fit: {syncs} host syncs (CUDA sync debug mode)",
          flush=True)
    n = Xs.shape[0]
    w = torch.ones(n, device=dev)
    idx = torch.as_tensor(engine.sample_indices(
        np.random.default_rng([0, engine.SKETCH_SEED]), n, 4096), device=dev)
    stats = tqk.fit_prestats(Xs, quantum=True, mu_grid=tqk.MU_GRID,
                             sketch_idx=idx)
    gen = as_generator(0, dev)
    sub = resolve_init_subsample(n, 6, "auto")
    c0 = tqk._restart_inits(gen, stats["Xc"], w, stats["xsq"], n_init=10,
                            init="k-means++", n_clusters=6,
                            init_subsample=sub)
    gum = torch.empty((10, n, 6), device=dev).exponential_(
        generator=gen).log_().neg_()
    labels, min_d2, sums, counts, _ = lloyd_step(
        stats["Xc"], w, stats["xsq"], c0, gumbel=gum, window=0.5)

    def relocate():
        s, c = tqk.relocate_empty_clusters(stats["Xc"], w, labels, min_d2,
                                           sums, counts)
        return tqk._update_centers(s, c, c0)

    steps = {
        "prestats with the sketch (4096 rows)": lambda: tqk.fit_prestats(
            Xs, quantum=True, mu_grid=tqk.MU_GRID, sketch_idx=idx),
        "init (k-means++, 10 restarts, subsample)": lambda:
            tqk._restart_inits(gen, stats["Xc"], w, stats["xsq"], n_init=10,
                               init="k-means++", n_clusters=6,
                               init_subsample=sub),
        "Gumbel draw (10 × 50000 × 6)": lambda: torch.empty(
            (10, n, 6), device=dev).exponential_(generator=gen).log_().neg_(),
        "Lloyd step, 10 restarts, window 0.5": lambda: lloyd_step(
            stats["Xc"], w, stats["xsq"], c0, gumbel=gum, window=0.5),
        "relocation and center update": relocate,
        "E-step of the final re-evaluation (twice per fit)": lambda:
            tqk.e_step(gen, stats["Xc"], w, c0, stats["xsq"], delta=0.5,
                       mode="delta"),
    }
    for name, fn in steps.items():
        print(f"δ-sweep step, {name}: {events_ms(fn, torch):.4f} device ms",
              flush=True)
    delta_sweep_fit_with_obs(est, Xs, idx, syncs, torch)


def wall_ms(fn, torch, reps=5):
    """Median host milliseconds of ``fn`` up to the device's end, after one
    warm-up (for steps that make the host wait inside)."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def delta_sweep_fit_with_obs(est, Xs, idx, syncs_off, torch):
    """The δ-sweep fit with obs on, beside the obs-off run: wall clock,
    profile, host syncs, the records, and the audit's pieces alone."""
    import tempfile

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.models import qkmeans as tqk
    from sq_learn_tpu_torch.sketch import engine

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.jsonl")
        obs.enable(path)
        try:
            for label in ("warm", "warm"):
                t0 = time.perf_counter()
                clone(est).fit(Xs)
                print(f"{label} δ-sweep fit with obs on: "
                      f"{time.perf_counter() - t0:.4f} s", flush=True)
            profiled("δ-sweep fit with obs on", lambda: clone(est).fit(Xs),
                     torch)
            obs.enable(path)  # a fresh run: the one fit's records
            fit, syncs = count_syncs(lambda: clone(est).fit(Xs), torch)
            rec = obs.get_recorder()
            sites = {}
            for g in rec.guarantee_records:
                sites[g["site"]] = sites.get(g["site"], 0) + 1
            print(f"δ-sweep fit with obs on: {syncs} host syncs (CUDA sync "
                  f"debug mode; {syncs_off} with obs off), "
                  f"{len(rec.spans)} spans "
                  f"({sorted({sp['name'] for sp in rec.spans})}), "
                  f"{len(rec.ledger_entries)} ledger entries, guarantee "
                  f"records by site {sites}", flush=True)
            sstats = engine.finalize_components(
                engine.fetch_components(engine.sketch_components(
                    Xs, idx, tqk.MU_GRID)), n=Xs.shape[0], m=Xs.shape[1],
                s=idx.shape[0], mu_grid=tqk.MU_GRID, delta_stat=0.05)
            pieces = {
                "the fit's δ-window replay (256 rows)": lambda:
                    fit._audit_fit_entry(Xs, 0, torch.as_tensor(
                        fit.cluster_centers_, device=Xs.device)),
                "the sketch's exact-μ audit": lambda:
                    engine.audit_sketch(sstats, Xs),
                "the ledger entry": lambda: fit._ledger_fit_entry(Xs),
            }
            for name, fn in pieces.items():
                _, n_syncs = count_syncs(fn, torch)
                print(f"δ-sweep obs piece, {name}: {wall_ms(fn, torch):.4f} "
                      f"host ms, {n_syncs} host syncs", flush=True)
        finally:
            obs.disable()


def minibatch_fit(X, torch):
    """One mini-batch q-means fit at 70 000 × 784 (δ=0.5, batch 1024),
    whole and step by step."""
    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.models import MiniBatchQKMeans
    from sq_learn_tpu_torch.models import minibatch as tmb
    from sq_learn_tpu_torch.utils import as_generator
    from sq_learn_tpu_torch.utils.validation import check_array

    dev = torch.device("cuda:0")
    est = MiniBatchQKMeans(n_clusters=10, batch_size=1024, delta=0.5,
                           random_state=0)
    for label in ("cold", "warm", "warm"):
        t0 = time.perf_counter()
        fit = clone(est).fit(X)
        wall = time.perf_counter() - t0
        print(f"{label} mini-batch fit: {wall:.4f} s, n_iter_ {fit.n_iter_}, "
              f"n_steps_ {fit.n_steps_} ({fit.n_steps_ / wall:.1f} steps/s)",
              flush=True)
    profiled("mini-batch fit", lambda: clone(est).fit(X), torch)
    _, syncs = count_syncs(lambda: clone(est).fit(X), torch)
    print(f"mini-batch fit: {syncs} host syncs (CUDA sync debug mode)",
          flush=True)
    Xd = check_array(X, device=dev)
    w = torch.ones(Xd.shape[0], device=dev)
    gen = as_generator(0, dev)
    centers = torch.as_tensor(fit.cluster_centers_, device=dev)
    counts = torch.as_tensor(fit.counts_, device=dev)
    n_pad = -(-Xd.shape[0] // 1024) * 1024 - Xd.shape[0]
    wp = torch.cat([w, torch.zeros(n_pad, device=dev)])
    kw = {"delta": 0.5, "mode": "delta", "reassignment_ratio": 0.01}
    steps = {
        "upload (check_array, pageable)": lambda: check_array(X, device=dev),
        "one step, 1024 rows, with the reassignment draw": lambda:
            tmb.minibatch_step(gen, Xd[:1024], w[:1024], centers, counts, 9,
                               **kw),
        "one epoch (69 steps, the permutation included)": lambda:
            tmb.minibatch_epoch(gen, Xd, wp, centers, counts, 0, batch=1024,
                                **kw),
        "init selection (3 candidates on 3072 rows)": lambda:
            fit._select_init(gen, Xd, w, 1024, 3, 0.5),
        "labels and inertia of all rows": lambda: fit._full_assign(Xd, w),
    }
    for name, fn in steps.items():
        print(f"mini-batch step, {name}: {events_ms(fn, torch):.4f} device "
              f"ms", flush=True)


def grid_fold(X, y, torch):
    """One fold of the error-budget grid search as ``cross_validate``
    runs it (``GridSearchCV(Pipeline(StandardScaler, QPCA(61),
    KNeighborsClassifier(7)))``, StratifiedKFold(5)): the host's index
    copies, the pipeline's fit and its score, then under the profiler."""
    from sq_learn_tpu_torch import Pipeline
    from sq_learn_tpu_torch.model_selection import StratifiedKFold
    from sq_learn_tpu_torch.models import QPCA, KNeighborsClassifier
    from sq_learn_tpu_torch.preprocessing import StandardScaler

    train, test = next(StratifiedKFold(5).split(X, y))

    def pipe():
        return Pipeline([("scale", StandardScaler()),
                         ("pca", QPCA(n_components=61, svd_solver="full",
                                      random_state=0)),
                         ("knn", KNeighborsClassifier(n_neighbors=7))])

    def fold():
        t0 = time.perf_counter()
        X_tr, y_tr, X_te, y_te = X[train], y[train], X[test], y[test]
        t1 = time.perf_counter()
        est = pipe().fit(X_tr, y_tr)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        score = est.score(X_te, y_te)
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2, score

    for label in ("cold", "warm", "warm"):
        index_s, fit_s, score_s, score = fold()
        print(f"{label} grid-search fold (56000 train, 14000 test rows): "
              f"host index copy {index_s:.4f} s, pipeline fit {fit_s:.4f} s,"
              f" score {score_s:.4f} s, accuracy {score}", flush=True)
    profiled("grid-search fold", fold, torch)


def _intervals(trace, cats, name=""):
    """Merged [start, end) intervals (µs) of the chrome-trace events whose
    category is in ``cats`` and whose name holds ``name``."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace
                   if e.get("cat") in cats and "dur" in e
                   and name in e.get("name", ""))
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _length(intervals):
    return sum(b - a for a, b in intervals)


def _overlap(xs, ys):
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def copy_compute_overlap(label, fn, torch):
    """Run ``fn`` once under the profiler and read its trace: the
    host→device copies' device time, the kernels' device time, the share
    of copy time during which a kernel runs too, and the device's busy
    share of the wall clock."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)["traceEvents"]
    copies = _intervals(trace, {"gpu_memcpy"}, "HtoD")
    kernels = _intervals(trace, {"kernel"})
    busy = _intervals(trace, {"gpu_memcpy", "kernel", "gpu_memset"})
    streams = sorted({e["args"].get("stream") for e in trace
                      if e.get("cat") == "gpu_memcpy" and "args" in e
                      and "HtoD" in e.get("name", "")})
    both = _overlap(copies, kernels)
    print(f"{label}: wall {wall * 1e3:.3f} ms; host→device copies "
          f"{_length(copies) / 1e3:.3f} ms of device time on stream(s) "
          f"{streams}, kernels {_length(kernels) / 1e3:.3f} ms; copies "
          f"overlapped by a kernel {both / 1e3:.3f} ms = "
          f"{100 * both / max(_length(copies), 1e-9):.2f} % of copy time; "
          f"device busy {_length(busy) / 1e3:.3f} ms = "
          f"{_length(busy) / 1e4 / wall:.2f} % of the wall clock",
          flush=True)


def streaming(X, torch):
    """The streamed ingest (``sq_learn_tpu_torch.streaming``): the resident
    put and the pageable upload it replaces, BASELINE #3's fit streamed
    against the same fit with the cap lifted (a monolithic pageable
    upload), the streamed qPCA fit against the monolithic one, in turns;
    then the copy/compute overlap of each streamed path under the
    profiler; last the streamed TruncatedSVD fit of BASELINE #4 against
    the monolithic one."""
    import numpy as np

    from sq_learn_tpu_torch.base import clone
    from sq_learn_tpu_torch.datasets import load_covtype
    from sq_learn_tpu_torch.decomposition import TruncatedSVD
    from sq_learn_tpu_torch.models import QPCA, QKMeans
    from sq_learn_tpu_torch.streaming import streamed_resident_put

    def walls(label, fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        print(f"{label}: {', '.join(f'{w * 1e3:.3f}' for w in out)} ms",
              flush=True)

    def capped(cap, fn):
        """``fn()`` under the tile cap ``cap`` (1 << 40: no streaming)."""
        os.environ["SQ_STREAM_TILE_BYTES"] = str(cap)
        try:
            return fn()
        finally:
            del os.environ["SQ_STREAM_TILE_BYTES"]

    def lifted(fn):
        return capped(1 << 40, fn)

    def at_16(fn):
        return capped(16 << 20, fn)

    put = lambda: streamed_resident_put(X, device="cuda:0")  # noqa: E731
    put16 = lambda: streamed_resident_put(  # noqa: E731
        X, device="cuda:0", max_bytes=16 << 20)
    page = lambda: torch.from_numpy(X).to("cuda:0")  # noqa: E731
    for label, fn in (("pageable upload", page), ("resident put, 2 tiles",
                                                  put),
                      ("resident put, 14 tiles", put16),
                      ("pageable upload", page)):
        walls(f"{label} of 70000×784 float32", fn)
    km = QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
                 true_distance_estimate=False, sketch=0, random_state=0)
    for label, fn in (
            ("BASELINE #3 fit, monolithic pageable upload",
             lambda: lifted(lambda: clone(km).fit(X))),
            ("BASELINE #3 fit, streamed", lambda: clone(km).fit(X)),
            ("BASELINE #3 fit, streamed", lambda: clone(km).fit(X)),
            ("BASELINE #3 fit, monolithic pageable upload",
             lambda: lifted(lambda: clone(km).fit(X)))):
        walls(label, fn)
    pca = QPCA(n_components=61, svd_solver="full", random_state=0)
    for label, fn in (
            ("QPCA(61) fit, monolithic", lambda: lifted(
                lambda: clone(pca).fit(X))),
            ("QPCA(61) fit, streamed, 2 tiles", lambda: clone(pca).fit(X)),
            ("QPCA(61) fit, streamed, 14 tiles",
             lambda: at_16(lambda: clone(pca).fit(X))),
            ("QPCA(61) fit, monolithic", lambda: lifted(
                lambda: clone(pca).fit(X)))):
        walls(label, fn)
    copy_compute_overlap("resident put, 2 tiles", put, torch)
    copy_compute_overlap("resident put, 14 tiles", put16, torch)
    copy_compute_overlap("BASELINE #3 fit, streamed",
                         lambda: clone(km).fit(X), torch)
    copy_compute_overlap("BASELINE #3 fit, monolithic pageable upload",
                         lambda: lifted(lambda: clone(km).fit(X)), torch)
    copy_compute_overlap("QPCA(61) fit, streamed, 14 tiles",
                         lambda: at_16(lambda: clone(pca).fit(X)), torch)
    copy_compute_overlap("QPCA(61) fit, monolithic",
                         lambda: lifted(lambda: clone(pca).fit(X)), torch)
    Xc = load_covtype()[0]
    svd = TruncatedSVD(n_components=10, n_iter=5, random_state=0)
    streamed = lambda: at_16(  # noqa: E731
        lambda: clone(svd).set_params(ingest="streamed").fit(Xc))
    t0 = time.perf_counter()
    streamed()
    torch.cuda.synchronize()
    print(f"TruncatedSVD(10) fit 581012×54, streamed at 16 MiB tiles, its "
          f"first fit: {(time.perf_counter() - t0) * 1e3:.3f} ms",
          flush=True)
    for label, fn in (
            ("TruncatedSVD(10) fit 581012×54, monolithic",
             lambda: clone(svd).fit(Xc)),
            ("TruncatedSVD(10) fit 581012×54, streamed at 16 MiB tiles",
             streamed),
            ("TruncatedSVD(10) fit 581012×54, monolithic",
             lambda: clone(svd).fit(Xc))):
        walls(label, fn)
    copy_compute_overlap("TruncatedSVD(10) fit, streamed at 16 MiB tiles",
                         streamed, torch)
    # the streamed fit's total variance is taken on the host, in float64,
    # as the JAX package takes it
    walls("TruncatedSVD streamed fit's host total variance alone",
          lambda: float(np.var(Xc, axis=0, dtype=np.float64).sum()))


def oocore(torch):
    """The out-of-core plane on S1: where one epoch of the store-backed
    mini-batch fit and its labelling pass spend their time (see the module
    docstring)."""
    import shutil
    import tempfile
    import zlib

    import numpy as np

    from sq_learn_tpu_torch import oocore as ooc
    from sq_learn_tpu_torch.models import MiniBatchQKMeans
    from sq_learn_tpu_torch.models.minibatch import minibatch_step
    from sq_learn_tpu_torch.oocore.fit import _BatchUploader, keyed_generator
    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    def wall(label, fn, reps=1):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        print(f"{label}: {', '.join(f'{w:.3f}' for w in out)} s",
              flush=True)
        return min(out)

    def env(**values):
        for k, v in values.items():
            os.environ[k] = str(v)

    tmp = tempfile.mkdtemp(prefix="sq-ooc-profile-")
    try:
        env(SQ_OOC_PREFETCH_THREADS=6)
        t0 = time.perf_counter()
        S1 = ooc.create_synthetic_store(os.path.join(tmp, "s1"), 1_000_000,
                                        784, n_classes=10, seed=784)
        del os.environ["SQ_OOC_PREFETCH_THREADS"]
        print(f"S1 built in {time.perf_counter() - t0:.3f} s, "
              f"{S1.n_shards} shards, {S1.nbytes / 1e9:.3f} GB", flush=True)
        gb = S1.nbytes / 1e9
        kw = dict(n_clusters=10, batch_size=1024, max_iter=2,
                  max_no_improvement=None, delta=0.5, random_state=0)
        est = MiniBatchQKMeans(**kw)
        fit_s = wall("S1 mini-batch fit (2 epochs + labelling), cold then "
                     "warm", lambda: est.fit(S1), reps=2)
        centers = est.cluster_centers_
        label_s = wall("S1 labelling pass (977 Lloyd launches)",
                       lambda: ooc.assign_labels(S1, centers,
                                                 batch_rows=1024), reps=2)
        plan = ooc.EpochPlan(seed=0, batch_rows=1024)
        for verify, depth in (("off", 0), ("all", 0), ("all", 2)):
            env(SQ_OOC_VERIFY=verify, SQ_OOC_PREFETCH_DEPTH=depth)
            s = wall(f"one epoch's host batch walk, CRC {verify}, readahead "
                     f"depth {depth}",
                     lambda: sum(1 for _ in plan.iter_batches(S1, 0)),
                     reps=2)
            print(f"  = {gb / s:.3f} GB/s", flush=True)
        os.environ.pop("SQ_OOC_VERIFY")
        os.environ.pop("SQ_OOC_PREFETCH_DEPTH")
        shard = S1.read_shard(0)
        t0 = time.perf_counter()
        for _ in range(S1.n_shards):
            zlib.crc32(shard)
        crc_s = time.perf_counter() - t0
        print(f"zlib.crc32 over {S1.n_shards} shards of 8 MiB (one epoch's "
              f"bytes): {crc_s:.3f} s = {gb / crc_s:.3f} GB/s", flush=True)
        batches = [np.ascontiguousarray(b, np.float32)
                   for _, b in plan.iter_batches(S1, 0)]
        up = _BatchUploader(torch.device("cuda:0"), 1024 * 784 * 4)
        try:
            up_s = wall("uploads of one epoch's 977 batches through the "
                        "pinned ring",
                        lambda: [up(b, i) for i, b in enumerate(batches)],
                        reps=2)
        finally:
            up.close()
        print(f"  = {gb / up_s:.3f} GB/s", flush=True)
        Xb = torch.from_numpy(batches[0]).to("cuda:0")
        wb = torch.ones(1024, device="cuda:0")
        C = torch.from_numpy(centers).to("cuda:0")
        counts = torch.ones(10, device="cuda:0")

        def step():
            minibatch_step(keyed_generator("cuda:0", 0, 0, 0, 0xBA7C), Xb,
                           wb, C, counts, 0, delta=0.5, mode="delta",
                           reassignment_ratio=0.01)

        step_ms = events_ms(step, torch)
        xsq = torch.sum(Xb * Xb, dim=1)
        lloyd_ms = events_ms(lambda: lloyd_step(Xb, wb, xsq, C[None]),
                             torch)
        print(f"one mini-batch step (δ=0.5, reassignment on) {step_ms:.4f} "
              f"device ms, × 977 = {977 * step_ms / 1e3:.3f} s an epoch; one "
              f"labelling Lloyd launch {lloyd_ms:.4f} device ms, × 977 = "
              f"{977 * lloyd_ms / 1e3:.3f} s; the fit {fit_s:.3f} s, the "
              f"labelling pass {label_s:.3f} s", flush=True)
        del batches
        one = MiniBatchQKMeans(**dict(kw, max_iter=1, compute_labels=False))
        profiled("S1 mini-batch fit, one epoch", lambda: one.fit(S1), torch)
        profiled("S1 labelling pass",
                 lambda: ooc.assign_labels(S1, centers, batch_rows=1024),
                 torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    if sys.argv[1:] == ["--streaming"]:
        streaming(X, torch)
        return 0
    if sys.argv[1:] == ["--oocore"]:
        oocore(torch)
        return 0
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
    argkmin_kernels(X, torch)
    knn(X, y, torch)
    qpca_trial(X, y, torch)
    qkmeans_quantum(X, torch)
    qlssvc(X, y, torch)
    delta_sweep_fit(torch)
    grid_fold(X, y, torch)
    minibatch_fit(X, torch)
    streaming(X, torch)
    oocore(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
