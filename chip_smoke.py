#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sq_learn_tpu_torch``) on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs one NVIDIA Hopper card and exits non-zero without one. Phases,
each of which fails the run:

1. Build every kernel of the port from ``sq_learn_tpu_torch/csrc``
   (set-up time).
2. Kernel phase: at the q-means slice shape (70 000 × 784, k=10, R=10
   restarts) hold the fused Lloyd kernel against its plain torch version
   on the card — float32 at window 0, float32 at window 0.5 and at a wide
   window on one shared Gumbel operand, bfloat16 — and time both (CUDA
   events, median), and the kernel once more with one restart (R=1): it
   reads X a fixed number of times whatever R is, so R=10 must cost under
   0.4 × 10 times R=1 (a timing check, not a count of bytes). Labels must
   be equal but where the exact (float64) distances put a center nearer to
   the deciding boundary than the measured float32 error. Three `active`
   masks (every other restart off, only the last on, all but the first
   on) run the kernel's restart compaction: the active restarts' outputs
   must be bit-equal to the unmasked launch's, the inactive ones zeros.
   Then the fused k-nearest search (argkmin) on the surrogate split as
   MNIST is (60 000 train rows, 10 000 queries, 784 wide, k=7), and at
   k=1, k=100, k=4096 on 256 queries (lists in global memory), width 61,
   16 queries (train split over many blocks) and integer-valued rows
   (exact ties): lists held against the exact float64 ones and the plain
   version's up to a margin of 3× the measured distance error, d2 at rtol
   1e-4 of the plain version's, ascending, bit-identical over two
   launches; planted duplicate rows come back lower index first.
3. Main paths, each with the kernels' launch counts set to 0 before it
   and read after it:
   - ``QKMeans(n_clusters=10, n_init=10, max_iter=300, delta=0.5,
     true_distance_estimate=False, sketch=0, random_state=0).fit`` on the
     MNIST-shaped surrogate, then ``predict``, ``score`` and
     ``transform``, then one δ=0 fit;
   - the same δ-means fit on ``graded_pair_surrogate(70_000, 784,
     _MNIST_LOW_MARGIN_GRADES, seed=785)``, whose class pairs overlap so
     that the Lloyd loop runs many launches (ARI ≥ 0.95, launches and the
     warm wall clock printed);
   - ``KNeighborsClassifier(n_neighbors=7)`` fitted on the first 60 000
     rows, with ``predict``, ``predict_proba``, ``kneighbors`` and
     ``score`` on the last 10 000 (uniform and distance weights; accuracy
     ≥ 0.95), then ``cross_validate`` over ``StratifiedKFold(10)`` on all
     70 000 rows, one kernel launch per fold.
   Small fits on the card (δ=0 q-means; k-NN on 4 000 rows) are checked
   against the same fits on the CPU (the plain versions).
4. Print the card, a ``kernels`` JSON line and, last, the ``ok`` line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

N, M, K, R = 70_000, 784, 10, 10
WINDOW = 0.5
# d2 cancels ‖x‖² + ‖c‖² against 2·x·c: float32 sums taken in another
# order differ by a few ulps of those terms, so min_d2 is held against the
# plain version at D2_RTOL times their size.
D2_RTOL = 1e-5
SUMS_RTOL = 1e-4   # float32 partial sums summed in another order
BF16_MAX_FLIPS = 0.01
# a wide window, at this quantile of the gap between each row's nearest and
# second-nearest center, puts two or more centers in a quarter of the
# rows' windows, so the Gumbel pick decides many labels
WIDE_WINDOW_QUANTILE = 0.25
WIDE_MIN_MOVED = 0.05  # share of labels the wide window must move
# R restarts must take under this share of R times one restart: X is read
# a fixed number of times whatever R is (R=10 took 2.1× R=1 on an H100)
R_TIME_RATIO = 0.4
ARI_FLOOR = 0.95   # the surrogate's classes are well separated
REPS = 10
# the k-NN slice: MnistTrial's k-NN on the MNIST split of the surrogate
N_TRAIN, KNN_K = 60_000, 7
CARD = "cuda:0"
KNN_ACCURACY_FLOOR = 0.95
K_GLOBAL = 4096    # lists too long for shared memory
EXACT_QUERIES = 2000  # queries held against exact float64 lists
# the kernel's and the plain version's d2 each err by a few float32 ulps of
# ‖t‖² ≈ 8·10⁴ against d2 of a few thousand
D2_RTOL_KNN = 1e-4
# the kernel's worst d2 error against float64 is held within this factor of
# the plain version's (1.11–1.21 on the card)
ERR_RATIO = 2.0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ari(a, b):
    """Adjusted Rand index of two labelings (numpy only)."""
    import numpy as np

    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def pairs(v):
        return (v * (v - 1) // 2).sum()

    index = pairs(table)
    ra, rb, total = pairs(table.sum(1)), pairs(table.sum(0)), pairs(
        np.asarray(len(a)))
    expected = ra * rb / total
    return float((index - expected) / (0.5 * (ra + rb) - expected))


def time_ms(fn, reps=REPS):
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after one warm-up call."""
    import torch

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


def unexplained_flips(d2, lab_k, lab_r, window, margin):
    """Rows where the kernel's label differs from the plain version's
    although the exact distances ``d2`` (R, n, k) put no center within
    ``margin`` of the boundary that decides the label: a second center
    as near as the nearest (window 0), or a center at the window's edge.
    With ``margin`` < ``window`` the nearest center itself never counts,
    so a wrong pick inside the window is caught."""
    diff = lab_k != lab_r
    if not bool(diff.any()):
        return 0
    d = d2[diff]
    dmin = d.min(dim=-1, keepdim=True).values
    if window > 0:
        explained = ((d - (dmin + window)).abs() <= margin).any(dim=-1)
    else:
        explained = ((d - dmin) <= margin).sum(dim=-1) >= 2
    return int((~explained).sum())


def kernel_phase(Xc, torch):
    """Hold the Lloyd kernel against its plain version at the slice
    shape; returns the kernel's JSON entry (launches filled in later)."""
    import numpy as np

    from sq_learn_tpu_torch.ops.kernels import (lloyd_step,
                                                lloyd_step_reference,
                                                lloyd_step_work)

    dev = Xc.device
    w = torch.ones(N, device=dev)
    xsq = torch.sum(Xc * Xc, dim=1)
    rng = np.random.default_rng(0)
    C = Xc[torch.from_numpy(rng.choice(N, (R, K))).to(dev)]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    gum = torch.empty((R, N, K), device=dev).exponential_(
        generator=g).log_().neg_()
    csq = torch.sum(C * C, dim=-1)
    tol = D2_RTOL * (xsq[None, :] + csq.max(dim=1).values[:, None])
    # the exact distances of the float32 operands, in float64: where a
    # label is decided and how near each row lies to a deciding boundary
    d2_exact = ((xsq.double()[None, :, None]
                 + (C.double() ** 2).sum(-1)[:, None, :])
                - 2.0 * torch.matmul(Xc.double(),
                                     C.double().transpose(1, 2)))
    top2 = torch.topk(d2_exact, 2, dim=-1, largest=False).values
    gap = (top2[..., 1] - top2[..., 0]).flatten()
    wide = float(torch.quantile(gap.float(),
                                WIDE_WINDOW_QUANTILE))
    in_window = int(((d2_exact <= top2[..., :1] + WINDOW).sum(-1) >= 2)
                    .sum())
    print(f"rows with two or more centers in the δ-window: {in_window} of "
          f"{R * N} at window {WINDOW}; wide window {wide:.4f} (the "
          f"{WIDE_WINDOW_QUANTILE} quantile of the nearest-center gap)",
          flush=True)

    # (name, X, Gumbel operand, window, timed)
    cases = [("float32", Xc, None, 0.0, True),
             ("float32", Xc, gum, WINDOW, True),
             ("float32", Xc, gum, wide, False),
             ("bfloat16", Xc.to(torch.bfloat16), None, 0.0, True)]
    report = {}
    for name, Xk, noise, window, timed in cases:
        out = lloyd_step(Xk, w, xsq, C, gumbel=noise, window=window)
        ref = lloyd_step_reference(Xk, w, xsq, C, gumbel=noise,
                                   window=window)
        torch.cuda.synchronize()
        lab_k, lab_r = out[0], ref[0]
        flips = int((lab_k != lab_r).sum())
        # the floats, held against the plain version on the kernel's labels
        k_ids = torch.arange(K, device=dev)
        onehot = (lab_k[..., None] == k_ids).float()
        xw = (Xk.float() * w[:, None]).to(Xk.dtype).float()
        sums_ref = torch.matmul(onehot.transpose(1, 2), xw)
        counts_ref = onehot.sum(dim=1)
        err = {
            "min_d2": float((out[1] - ref[1]).abs().max()),
            "sums": float((out[2] - sums_ref).abs().max()),
            "counts": float((out[3] - counts_ref).abs().max()),
            "inertia": float((out[4] - ref[4]).abs().max()),
        }
        case = f"{name} window {window:.4f}"
        check(bool(((out[1] - ref[1]).abs() <= tol).all()),
              f"{case}: min_d2 off by {err['min_d2']}")
        check(bool(torch.allclose(out[2], sums_ref, rtol=SUMS_RTOL,
                                  atol=SUMS_RTOL * float(sums_ref.abs()
                                                         .max()))),
              f"{case}: sums off by {err['sums']}")
        check(bool(torch.equal(out[3], counts_ref)),
              f"{case}: counts off by {err['counts']}")
        check(bool(torch.allclose(out[4], ref[4], rtol=SUMS_RTOL)),
              f"{case}: inertia off by {err['inertia']}")
        if name == "bfloat16":
            check(flips <= BF16_MAX_FLIPS * R * N,
                  f"bfloat16: {flips} label flips of {R * N}")
            detail = f"at most {BF16_MAX_FLIPS:.0%} allowed"
        else:
            # A label may differ from the exact (float64) decision only
            # where a center lies nearer to the deciding boundary than the
            # float32 distances can be off: three times the worst error of
            # the kernel's min_d2 against the exact one, seen on 700 000
            # nearest distances (tripled for the tails of the others). The
            # plain version (cuBLAS, long sequential sums) errs more, so
            # the kernel is held against it at the larger of the two.
            exact_min = top2[..., 0]
            if window > 0:
                exact_lab = torch.argmax(torch.where(
                    d2_exact <= (exact_min + window)[..., None], noise,
                    torch.full_like(noise, -torch.inf)), dim=-1)
            else:
                exact_lab = torch.argmin(d2_exact, dim=-1)
            err["min_d2_exact"] = float((out[1] - exact_min).abs().max())
            plain_err = float((ref[1] - exact_min).abs().max())
            margin = 3.0 * err["min_d2_exact"]
            check(window == 0 or margin < window,
                  f"{case}: distance error margin {margin} does not "
                  f"resolve the window")
            for other, m_other, what in (
                    (exact_lab, margin, "the exact decision"),
                    (lab_r, 3.0 * max(err["min_d2_exact"], plain_err),
                     "the plain version")):
                bad = unexplained_flips(d2_exact, lab_k, other, window,
                                        m_other)
                check(bad == 0, f"{case}: {bad} of "
                                f"{int((lab_k != other).sum())} label flips "
                                f"against {what} are not within {m_other} "
                                f"of a deciding boundary")
            flips_exact = int((lab_k != exact_lab.to(lab_k.dtype)).sum())
            detail = (f"{flips_exact} against the exact decision at margin "
                      f"{margin}; the plain version's min_d2 error "
                      f"{plain_err}")
            if window == wide:
                moved = float((lab_k != d2_exact.argmin(-1)).float().mean())
                check(moved >= WIDE_MIN_MOVED,
                      f"{case}: the pick moved only {moved:.4f} of the "
                      f"labels off the nearest center")
                print(f"{case}: the Gumbel pick moved {moved:.4f} of the "
                      f"labels off the nearest center", flush=True)
        again = lloyd_step(Xk, w, xsq, C, gumbel=noise, window=window)
        check(all(bool(torch.equal(a, b)) for a, b in zip(out, again)),
              f"{case}: two launches differ")
        line = (f"lloyd_step {case} R={R}: label flips {flips}/{R * N} "
                f"({detail}), max |err| {err}")
        if timed:
            ms = time_ms(lambda: lloyd_step(Xk, w, xsq, C, gumbel=noise,
                                            window=window))
            plain_ms = time_ms(lambda: lloyd_step_reference(
                Xk, w, xsq, C, gumbel=noise, window=window))
            nbytes, ops = lloyd_step_work(N, M, K, R, Xk.dtype, window)
            peak = 989e12 if Xk.dtype == torch.bfloat16 else 67e12
            bytes_ms, ops_ms = nbytes / 3.35e12 * 1e3, ops / peak * 1e3
            report[(name, window)] = {
                "flips": flips, "err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            line += (f"; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                     f"{max(bytes_ms, ops_ms):.4f} ms by "
                     f"{report[(name, window)]['bound_by']})")
        print(line, flush=True)
    # the restart compaction the graded fit's launches run: an active
    # restart gets the bits of the unmasked launch (held against the plain
    # version above), an inactive one zeros
    full = lloyd_step(Xc, w, xsq, C, gumbel=gum, window=WINDOW)
    ids = torch.arange(R, device=dev)
    for what, on in (("every other restart off", ids % 2 == 0),
                     ("only the last restart on", ids == R - 1),
                     ("all but the first restart on", ids > 0)):
        masked = lloyd_step(Xc, w, xsq, C, gumbel=gum, window=WINDOW,
                            active=on)
        torch.cuda.synchronize()
        for part, a, b in zip(("labels", "min_d2", "sums", "counts",
                               "inertia"), masked, full):
            check(not bool(a[~on].any()),
                  f"active mask, {what}: {part} of an inactive restart "
                  f"are not zero")
            check(bool(torch.equal(a[on], b[on])),
                  f"active mask, {what}: {part} of the active restarts "
                  f"differ from the unmasked launch")
        print(f"lloyd_step active mask, {what}: active restarts bit-equal "
              f"to the unmasked launch, inactive ones zero", flush=True)
    main = report[("float32", WINDOW)]
    # one restart: X is read a fixed number of times, whatever R is. This
    # is a timing check, not a count of bytes: one more read of X costs
    # ~0.07 ms, so it holds the design as a whole, not the count of reads
    r1_ms = time_ms(lambda: lloyd_step(Xc, w, xsq, C[:1], gumbel=gum[:1],
                                       window=WINDOW))
    check(main["ms"] < R_TIME_RATIO * R * r1_ms,
          f"lloyd_step R={R} takes {main['ms']} ms, R=1 {r1_ms} ms: more "
          f"than {R_TIME_RATIO} × {R} times R=1")
    print(f"lloyd_step float32 window {WINDOW}: R=1 {r1_ms:.4f} ms, R={R} "
          f"{main['ms']:.4f} ms ({main['ms'] / r1_ms:.2f}x)", flush=True)
    return {"name": "lloyd_step", "route": "cuda",
            "source": "sq_learn_tpu_torch/csrc/lloyd.cu",
            "replaces": "sq_learn_tpu/ops/pallas_kernels.py:117",
            "launches": None,
            "max_abs_err": max(main["err"].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None}


def exact_sq_distances(Q, T):
    """(nq, nt) squared distances of the float32 rows Q and T, in float64
    (exact to ~1e-11 at these norms)."""
    Q64, T64 = Q.double(), T.double()
    return ((Q64 * Q64).sum(1)[:, None] + (T64 * T64).sum(1)[None, :]
            - 2.0 * Q64 @ T64.T)


def hold_lists(case, idx, d2, ref_i, ref_d, Qk, Tk, torch):
    """Hold the kernel's neighbor lists against the exact ones (float64
    distances of the same float32 operands, on the first EXACT_QUERIES
    queries) and against the plain version's. A list may differ from the
    exact one only where the exact distance of its row at some position
    lies within ``margin`` of the exact distance that belongs there (two
    near-equal rows swapped, or the k-th row and the exact (k+1)-th);
    ``margin`` is 3× the kernel's own worst |d2 − exact|, which must itself
    stay within ERR_RATIO times the plain version's (so a kernel whose d2
    do not belong to its rows cannot widen its own margin). Against the
    plain version the margin is 3× the larger of the two errors. Returns
    the errors and flip counts."""
    k = idx.shape[1]
    nq = min(EXACT_QUERIES, Qk.shape[0])
    err_k = err_p = dev_exact = dev_plain = 0.0
    flips_exact = 0
    for q0 in range(0, nq, 500):
        q1 = min(nq, q0 + 500)
        D = exact_sq_distances(Qk[q0:q1], Tk)
        best = torch.sort(D, dim=1, stable=True)
        dk = D.gather(1, idx[q0:q1].long())
        dp = D.gather(1, ref_i[q0:q1].long())
        err_k = max(err_k, float((d2[q0:q1].double() - dk).abs().max()))
        err_p = max(err_p, float((ref_d[q0:q1].double() - dp).abs().max()))
        dev_exact = max(dev_exact,
                        float((dk - best.values[:, :k]).abs().max()))
        dev_plain = max(dev_plain, float((dk - dp).abs().max()))
        flips_exact += int((idx[q0:q1].long() != best.indices[:, :k]).sum())
    check(err_k <= ERR_RATIO * err_p,
          f"argkmin {case}: d2 off the exact distances of its own rows by "
          f"{err_k}, more than {ERR_RATIO} × the plain version's {err_p}")
    margin = 3.0 * err_k
    check(dev_exact <= margin,
          f"argkmin {case}: a list differs from the exact one by {dev_exact} "
          f"in exact distance, beyond the margin {margin}")
    margin_p = 3.0 * max(err_k, err_p)
    check(dev_plain <= margin_p,
          f"argkmin {case}: a list differs from the plain version's by "
          f"{dev_plain} in exact distance, beyond the margin {margin_p}")
    return {"d2_err_exact": err_k, "plain_d2_err_exact": err_p,
            "margin": margin, "flips_exact": flips_exact,
            "exact_queries": nq}


def argkmin_phase(Xd, torch):
    """Hold the argkmin kernel against its plain version and the exact
    lists on the surrogate split as MNIST is (train rows [:60000], queries
    [60000:], uncentered); returns the kernel's JSON entry (launches filled
    in later)."""
    from sq_learn_tpu_torch.ops.kernels import (argkmin,
                                                argkmin_lists_in_shared,
                                                argkmin_plan,
                                                argkmin_reference,
                                                argkmin_tiles,
                                                argkmin_work)

    dev = Xd.device
    T, Q = Xd[:N_TRAIN].contiguous(), Xd[N_TRAIN:].contiguous()
    # small integers: every product and sum is exact in float32, so scores
    # tie exactly and often, and the kernel must give the plain lists
    Ti = torch.round(T / 8.0).contiguous()
    Qi = torch.round(Q / 8.0).contiguous()
    check(not argkmin_lists_in_shared(K_GLOBAL, dev)
          and argkmin_lists_in_shared(100, dev),
          f"k={K_GLOBAL} must take the global-memory lists, k=100 the "
          f"shared-memory ones")
    # (name, train, queries, k, timed, exact)
    cases = [("main 10000×60000×784 k=7", T, Q, KNN_K, True, False),
             ("k=1", T, Q, 1, False, False),
             ("k=100", T, Q, 100, False, False),
             (f"k={K_GLOBAL} on 256 queries (lists in global memory)", T,
              Q[:256].contiguous(), K_GLOBAL, False, False),
             ("width 61", T[:, :61].contiguous(), Q[:, :61].contiguous(),
              KNN_K, False, False),
             ("16 queries (train split over blocks)", T,
              Q[:16].contiguous(), KNN_K, False, False),
             ("integer-valued rows (exact ties)", Ti, Qi, KNN_K, False,
              True)]
    entry = None
    for case, Tk, Qk, k, timed, exact in cases:
        tsq = torch.sum(Tk * Tk, dim=1)
        nq, nt = Qk.shape[0], Tk.shape[0]
        idx, d2 = argkmin(Tk, tsq, Qk, k)
        ref_i, ref_d = argkmin_reference(Tk, tsq, Qk, k)
        torch.cuda.synchronize()
        check(idx.shape == d2.shape == (nq, k) and idx.dtype == torch.int32
              and bool(torch.isfinite(d2).all()),
              f"argkmin {case}: output of the wrong shape or not finite")
        srt = torch.sort(idx, dim=1).values
        check(int(idx.min()) >= 0 and int(idx.max()) < nt
              and bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"argkmin {case}: indices out of range or repeated")
        check(bool((d2[:, 1:] >= d2[:, :-1]).all()),
              f"argkmin {case}: distances not ascending")
        err = float((d2 - ref_d).abs().max())
        check(bool(((d2 - ref_d).abs() <= D2_RTOL_KNN * ref_d.abs()).all()),
              f"argkmin {case}: d2 off the plain version's by {err}")
        flips_plain = int((idx != ref_i).sum())
        if exact:
            check(flips_plain == 0 and bool(torch.equal(d2, ref_d)),
                  f"argkmin {case}: {flips_plain} indices differ from the "
                  f"plain version on exactly tied scores")
            held = {}
        else:
            held = hold_lists(case, idx, d2, ref_i, ref_d, Qk, Tk, torch)
        again = argkmin(Tk, tsq, Qk, k)
        check(bool(torch.equal(again[0], idx) and torch.equal(again[1], d2)),
              f"argkmin {case}: two launches differ")
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, rows = argkmin_plan(nq, nt, k, n_sms, argkmin_tiles())
        line = (f"argkmin {case}: {splits} train splits of {rows} rows, "
                f"lists in {'shared' if argkmin_lists_in_shared(k, dev) else 'global'} "
                f"memory; {flips_plain} of {nq * k} indices differ from the "
                f"plain version, max |d2 − plain| {err}; {held}")
        if timed:
            ms = time_ms(lambda: argkmin(Tk, tsq, Qk, k))
            plain_ms = time_ms(lambda: argkmin_reference(Tk, tsq, Qk, k))
            nbytes, ops = argkmin_work(nq, nt, Tk.shape[1], k)
            bytes_ms, ops_ms = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
            entry = {"name": "argkmin", "route": "cuda",
                     "source": "sq_learn_tpu_torch/csrc/argkmin.cu",
                     "replaces": "sq_learn_tpu/ops/pallas_kernels.py:305",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": ("bytes" if bytes_ms >= ops_ms
                                  else "operations"),
                     "library_ms": None}
            line += (f"; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                     f"{entry['bound_ms']:.4f} ms by {entry['bound_by']})")
        print(line, flush=True)

    # planted duplicate rows: the lower index first, with equal d2, whether
    # the two rows share a tile, a split, or lie in different splits
    T2 = T.clone()
    dups = {N_TRAIN - 1: 0, N_TRAIN // 2: 1, 5: 2}
    for dst, src in dups.items():
        T2[dst] = T[src]
    tsq2 = torch.sum(T2 * T2, dim=1)
    for nq in (16, Q.shape[0] + 3):
        Q2 = torch.cat([T[:3], Q])[:nq].contiguous()
        idx, d2 = argkmin(T2, tsq2, Q2, KNN_K)
        torch.cuda.synchronize()
        for dst, src in dups.items():
            check(idx[src, :2].tolist() == [src, dst]
                  and float(d2[src, 0]) == float(d2[src, 1]),
                  f"argkmin ties ({nq} queries): row {src} and its copy "
                  f"{dst} came back as {idx[src, :3].tolist()} with d2 "
                  f"{d2[src, :3].tolist()}")
    print(f"argkmin ties: rows {sorted(dups.values())} copied to "
          f"{sorted(dups)} come back lower index first with equal d2, at "
          f"16 and {Q.shape[0] + 3} queries", flush=True)
    return entry


def graded_path(QKMeans):
    """The δ-means fit on the low-margin surrogate, whose overlapping class
    pairs keep the Lloyd loop running: twice (the second is warm), each
    with the launch count set to 0 before it."""
    import numpy as np

    from sq_learn_tpu_torch.datasets import (_MNIST_LOW_MARGIN_GRADES,
                                             graded_pair_surrogate)
    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    Xg, yg = graded_pair_surrogate(N, M, _MNIST_LOW_MARGIN_GRADES, seed=785)
    walls, launches = [], []
    for _ in range(2):
        est = QKMeans(n_clusters=K, n_init=10, max_iter=300, delta=WINDOW,
                      true_distance_estimate=False, sketch=0, random_state=0)
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        est.fit(Xg)
        walls.append(time.perf_counter() - t0)
        launches.append(lloyd_step.launches)
    check(launches[0] == launches[1] > 0,
          f"graded δ-means fit launched the kernel {launches} times")
    check(np.isfinite(est.cluster_centers_).all()
          and np.isfinite(est.inertia_), "graded δ-means fit is not finite")
    fit_ari = ari(yg, est.labels_)
    check(fit_ari >= ARI_FLOOR, f"graded δ-means ARI {fit_ari} < {ARI_FLOOR}")
    print(f"QKMeans δ=0.5 δ-means fit on graded_pair_surrogate(70000, 784, "
          f"{_MNIST_LOW_MARGIN_GRADES}, seed=785): {walls[0]:.4f} s, warm "
          f"{walls[1]:.4f} s, n_iter {est.n_iter_}, kernel launches "
          f"{launches[1]}, inertia {est.inertia_}, ARI {fit_ari}",
          flush=True)


def knn_main_path(X, y, torch):
    """k-NN through the entry points a user calls: fit on the first 60 000
    rows, predict/predict_proba/kneighbors/score on the last 10 000 (both
    weightings), then a 10-fold stratified CV on all 70 000."""
    import numpy as np

    from sq_learn_tpu_torch.model_selection import (StratifiedKFold,
                                                    cross_validate)
    from sq_learn_tpu_torch.models import KNeighborsClassifier
    from sq_learn_tpu_torch.ops.kernels import argkmin

    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    for weights in ("uniform", "distance"):
        t0 = time.perf_counter()
        est = KNeighborsClassifier(n_neighbors=KNN_K, weights=weights)
        est.fit(Xtr, ytr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            pred = est.predict(Xte)  # ends in the fetch of the labels
            walls.append(time.perf_counter() - t0)
        proba = est.predict_proba(Xte)
        dist, idx = est.kneighbors(Xte)
        acc = est.score(Xte, yte)
        check(acc >= KNN_ACCURACY_FLOOR,
              f"k-NN {weights}: accuracy {acc} < {KNN_ACCURACY_FLOOR}")
        check(np.array_equal(pred, est.classes_[np.argmax(proba, axis=1)]),
              f"k-NN {weights}: predict is not the argmax of predict_proba")
        check(np.allclose(proba.sum(1), 1.0), f"k-NN {weights}: proba rows")
        check(dist.shape == idx.shape == (len(Xte), KNN_K)
              and np.isfinite(dist).all()
              and (np.diff(dist, axis=1) >= 0).all(),
              f"k-NN {weights}: kneighbors distances not finite ascending")
        print(f"KNeighborsClassifier(n_neighbors={KNN_K}, weights="
              f"{weights!r}) 60000×784: fit {fit_s:.4f} s, predict 10000 "
              f"rows {walls[0]:.4f} s then {walls[1]:.4f} s, accuracy {acc}",
              flush=True)
    before = argkmin.launches
    t0 = time.perf_counter()
    res = cross_validate(KNeighborsClassifier(n_neighbors=KNN_K), X, y,
                         cv=StratifiedKFold(10))
    cv_s = time.perf_counter() - t0
    cv_launches = argkmin.launches - before
    check(cv_launches == 10, f"10-fold CV launched the kernel {cv_launches} "
                             f"times, not once per fold")
    check(res["test_score"].min() >= KNN_ACCURACY_FLOOR,
          f"CV fold accuracy {res['test_score'].min()}")
    print(f"cross_validate(KNeighborsClassifier(n_neighbors={KNN_K}), "
          f"StratifiedKFold(10)) 70000×784: {cv_s:.4f} s, kernel launches "
          f"{cv_launches}, test_score {res['test_score'].tolist()}, fit_time "
          f"{res['fit_time'].tolist()}, score_time "
          f"{res['score_time'].tolist()}", flush=True)


def knn_card_vs_cpu(X, y):
    """A 4000-row fit and 2000-row predict on the card against the same on
    the CPU (the plain version): predictions equal, neighbor lists equal
    but where the exact (float64) distances explain a swap."""
    import numpy as np

    from sq_learn_tpu_torch.models import KNeighborsClassifier

    Xtr, ytr, Xq = X[:4000], y[:4000], X[N_TRAIN:N_TRAIN + 2000]
    out = {}
    for device in (CARD, "cpu"):
        est = KNeighborsClassifier(n_neighbors=KNN_K, device=device)
        est.fit(Xtr, ytr)
        out[device] = (est.predict(Xq), *est.kneighbors(Xq))
    (pc, dc, ic), (pp, dp, ip) = out[CARD], out["cpu"]
    check(np.array_equal(pc, pp), "small k-NN: card and CPU predict differ")
    Q64, T64 = Xq.astype(np.float64), Xtr.astype(np.float64)
    D = (Q64 ** 2).sum(1)[:, None] + (T64 ** 2).sum(1)[None] - 2 * Q64 @ T64.T
    ec = np.take_along_axis(D, ic.astype(np.int64), 1)
    ep = np.take_along_axis(D, ip.astype(np.int64), 1)
    err = max(np.abs(dc.astype(np.float64) ** 2 - ec).max(),
              np.abs(dp.astype(np.float64) ** 2 - ep).max())
    dev = float(np.abs(ec - ep).max())
    check(dev <= 3.0 * err,
          f"small k-NN: card and CPU lists differ by {dev} in exact "
          f"distance, beyond 3 × {err}")
    print(f"small k-NN 4000×784, 2000 queries: card == CPU predictions; "
          f"{int((ic != ip).sum())} of {ic.size} neighbor indices differ, "
          f"each within {dev} ≤ 3 × {err} in exact distance", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import sq_learn_tpu_torch as sqt

    check(os.path.dirname(os.path.abspath(sqt.__file__))
          == os.path.join(here, "sq_learn_tpu_torch"),
          "sq_learn_tpu_torch must come from this checkout")
    from sq_learn_tpu_torch.datasets import synthetic_surrogate
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.ops import _build
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # phase 1: build every kernel source, all at once (set-up time)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"kernels {sorted(built)} built in {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    for name in sorted(built):
        print(f"--- {name}.cu\n{_build.build_log(name)}", flush=True)

    dev = torch.device("cuda:0")
    sqt.set_config(device="cuda:0")
    X, y = synthetic_surrogate(N, M, K, seed=784)
    Xd = torch.from_numpy(X).to(dev)
    Xc = Xd - Xd.mean(dim=0)

    # phase 2: every kernel against its plain version
    entry = kernel_phase(Xc, torch)
    print("library_ms: null — no single PyTorch call computes the fused "
          "Lloyd step (distances, δ-window pick and weighted partial sums)",
          flush=True)
    knn_entry = argkmin_phase(Xd, torch)
    print("argkmin library_ms: null — no single PyTorch call computes a "
          "k-smallest search with lowest-index ties (torch.topk leaves the "
          "order of ties undocumented)", flush=True)

    # phase 3: the main path through the entry points a user calls
    est = QKMeans(n_clusters=K, n_init=10, max_iter=300, delta=WINDOW,
                  true_distance_estimate=False, sketch=0, random_state=0)
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    est.fit(X)
    fit_s = time.perf_counter() - t0
    entry["launches"] = lloyd_step.launches
    check(entry["launches"] > 0, "the δ-means fit never launched the kernel")
    check(np.isfinite(est.cluster_centers_).all()
          and np.isfinite(est.inertia_), "δ-means fit is not finite")
    check(est.cluster_centers_.shape == (K, M), "centers of the wrong shape")
    check(est.n_iter_ >= 1, "δ-means fit ran no iteration")
    fit_ari = ari(y, est.labels_)
    check(fit_ari >= ARI_FLOOR, f"δ-means ARI {fit_ari} < {ARI_FLOOR}")
    print(f"QKMeans δ=0.5 δ-means fit: {fit_s:.3f} s, n_iter {est.n_iter_}, "
          f"inertia {est.inertia_}, ARI {fit_ari}, kernel launches "
          f"{entry['launches']}, eta {est.eta_}, mu {est.mu_} "
          f"({est.norm_mu_}), kappa {est.condition_number_}", flush=True)
    pred = est.predict(X)
    score = est.score(X)
    dist = est.transform(X)
    check(pred.shape == (N,) and np.isfinite(score)
          and dist.shape == (N, K) and np.isfinite(dist).all(),
          "predict/score/transform output")
    check(ari(est.labels_, pred) >= ARI_FLOOR, "predict disagrees with fit")
    check(np.isclose(-score, est.inertia_, rtol=1e-2),
          f"score {score} vs inertia {est.inertia_}")
    check(np.array_equal(dist.argmin(1), pred), "transform argmin ≠ predict")

    classic = QKMeans(n_clusters=K, n_init=10, max_iter=300, delta=0.0,
                      random_state=0)
    lloyd_step.launches = 0
    t0 = time.perf_counter()
    classic.fit(X)
    classic_s = time.perf_counter() - t0
    classic_launches = lloyd_step.launches
    check(classic_launches > 0, "the δ=0 fit never launched the kernel")
    check(np.isfinite(classic.inertia_) and classic.n_iter_ >= 1,
          "δ=0 fit output")
    check(np.array_equal(classic.predict(X), classic.labels_),
          "δ=0 predict ≠ fit labels")
    print(f"QKMeans δ=0 fit: {classic_s:.3f} s, n_iter {classic.n_iter_}, "
          f"inertia {classic.inertia_}, ARI {ari(y, classic.labels_)}, "
          f"kernel launches {classic_launches}", flush=True)

    graded_path(QKMeans)

    # a small δ=0 fit on the card against the same fit in plain torch
    small = X[:4000]
    init = small[np.random.default_rng(1).choice(4000, K, replace=False)]
    on = {}
    for device in ("cuda:0", "cpu"):
        on[device] = QKMeans(n_clusters=K, init=init, n_init=1, delta=0.0,
                             max_iter=50, device=device).fit(small)
    check(np.array_equal(on["cuda:0"].labels_, on["cpu"].labels_)
          and on["cuda:0"].n_iter_ == on["cpu"].n_iter_,
          "small δ=0 fit: card and CPU disagree")
    check(np.allclose(on["cuda:0"].cluster_centers_,
                      on["cpu"].cluster_centers_, rtol=1e-4, atol=1e-4),
          "small δ=0 fit: centers disagree")
    print(f"small δ=0 fit 4000×784: card == CPU (labels, n_iter "
          f"{on['cpu'].n_iter_}, centers at rtol 1e-4)", flush=True)

    # the k-NN main path, its launches counted from 0
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    knn_main_path(X, y, torch)
    knn_entry["launches"] = argkmin.launches
    check(knn_entry["launches"] > 0, "the k-NN path never launched argkmin")
    print(f"k-NN path: {time.perf_counter() - t0:.3f} s, argkmin launches "
          f"{knn_entry['launches']}, lloyd_step launches "
          f"{lloyd_step.launches}", flush=True)
    knn_card_vs_cpu(X, y)

    print(smi)
    print(json.dumps({"kernels": [entry, knn_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
