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
   launches; planted duplicate rows come back lower index first. k picks
   the kernel (short lists, or long lists in shared or global memory),
   and each case runs on the one it picks. At the main shape the kernel
   must take under ARGKMIN_PLAIN_RATIO of its plain version's time, and
   ``torch.matmul(Q, T.T)`` alone in full float32 (TF32 off) is timed
   beside it as ``products_ms``: the products the kernel must do, as
   cuBLAS does them. Then the profiling phase (``utils.profiling`` and
   ``show_versions``, under PROFILING_PHASE_S seconds): the debug report
   names the card and torch's CUDA; ``benchmark`` of each kernel at the
   phase's main shapes (REPS repeats, synced after each call) lies within
   0.9× and 2× + 1 ms of its CUDA-event median, and its ``mfu`` (Lloyd:
   R × ``lloyd_iter_flops``; argkmin: the products' ``matmul_flops``)
   against the card's fp32 peak in (0, 1.05]; ``device_peak_flops()``
   resolves; a ``trace`` around one launch of each kernel holds CUDA
   kernel events named after a ``__global__`` function of each source.
   The phase's last part runs after every main path (so that the main
   path's fit stays the process's first): BASELINE #3's δ-means fit
   under ``Timer(name="profiling.qkmeans_fit")`` with obs on lands its
   span, ``obs.snapshot()["measured_mfu"]`` equals the ``profiling.mfu``
   gauge, and ``python -m sq_learn_tpu_torch.obs report`` prints the
   "measured MFU" line. That fit's launches join the kernels' totals;
   the benchmark and trace launches do not. The phase's figures print
   on a ``profiling:`` JSON line just before the card's name.
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
     70 000 rows, one kernel launch per fold;
   - the reference's MNIST trial (``examples/mnist_trial.py`` at
     ``--subsample 0``): ``QPCA(n_components=61, svd_solver="full",
     random_state=0).fit(X, estimate_all=True, eps=0.4, delta=0.4,
     theta_major=1e-9, true_tomography=False)``, the quantum transform
     and ``cross_validate(KNeighborsClassifier(n_neighbors=7), Xq, y,
     cv=StratifiedKFold(10))``: the spectrum within SPECTRUM_RTOL of a
     float64 Gram route, every σ̂ on consistent PE's snap grid (and the
     share on which a second fit with random_state=1 agrees), every
     tomography row within δ, Xq finite (70 000, 61), ten
     ``argkmin_short`` launches and every fold ≥ 0.95; then a
     true-tomography top-k extraction at the full shape (the multinomial
     split tree on vectors of 70 000 and 784, each row within δ). Before
     it the tree alone: ⌈log₂ d⌉ ``torch.binomial`` calls per call.
   - path A, q-means at the reference's defaults: ``QKMeans(n_clusters=10,
     n_init=10, max_iter=300, delta=0.5, random_state=0).fit`` (the IPE
     E-step, no kernel launch; sketch='auto', 4096 sampled rows), then
     ``predict(X, delta=0.5)``, ``score``, ``transform``, both runtime
     models and ``runtime_comparison``'s 100 × 100 surfaces: κ within
     SKETCH_KAPPA_RTOL of κ from the float64 Gram of the same sampled
     rows, ARI ≥ IPE_ARI_FLOOR;
   - path B, δ-means with true tomography of the centers every iteration
     (``intermediate_error=True``): Lloyd launches added to the kernel's,
     ARI ≥ TOMOGRAPHY_ARI_FLOOR, and a rerun of the same steps through
     the functional core, from the same seed, whose every restart is
     finite and whose best restart is the fit's centers, bit for bit;
   - path C, the qPCA trial fit's ``accumulate_q_runtime`` and
     ``runtime_comparison``: finite positive surfaces of the mesh's shape;
   - path D, ``QLSSVC`` (linear kernel with absolute error, rbf with
     relative error) on classes 0 and 1 of the surrogate as ±1, 8 000
     training and 2 000 test rows: classical accuracy, the singular
     values of F and ``cond_`` against a float64 decomposition of the same
     F, |P̃ − P| ≤ ε for both error types.
   The exact δ-means fit's κ is held within EXACT_KAPPA_RTOL of κ from the
   float64 Gram of X. Small fits on the card (δ=0 q-means; k-NN on 4 000
   rows; QPCA(16) at 4 000 × 64, ε = δ = 0; QLSSVC on 500 rows) are
   checked against the same fits on the CPU (the plain versions).
4. The reference's error-budget sweeps, each path with the counts set to
   0 before it and read after it:
   - the Lloyd kernel at the δ-sweep's shape (50 000 × 78, k=6, R=10,
     rows of 312 bytes that take the kernel's unaligned staging) against
     its plain version at window 0 and 0.5, as in phase 2, and timed;
   - BASELINE #5 (``examples/delta_tradeoff.py`` at ``--n-samples
     50000``): ``load_cicids`` (the surrogate), ``StandardScaler`` on the
     card, then ``QKMeans(n_clusters=6, n_init=10, delta=δ,
     true_distance_estimate=False, random_state=0)`` for δ in (0, 0.1,
     0.3, 0.5, 1.0): Lloyd launches in every fit, ARI 1.0 at δ=0 and at
     least the JAX package's less SWEEP_MARGIN above it; a δ=0 fit from
     one init, card == CPU (labels, n_iter);
   - BASELINE #4: ``TruncatedSVD(n_components=10, n_iter=5,
     random_state=0)`` on the covertype surrogate (581 012 × 54),
     'randomized' and 'arpack': singular values within 3× the JAX
     package's float32 error of a float64 spectrum computed on the card,
     orthonormal components, explained variance ratios in [0, 1]; the
     randomized fit again with ``ingest='streamed'`` at STREAM_TILE_BYTES
     (8 tiles a pass; the surrogate's 125.5 MB stays under the default
     cap): ``ingest_ == 'streamed'``, the same spectrum check, the
     components' subspace against the monolithic fit's (principal-angle
     cosines ≥ SUBSPACE_COS_FLOOR); a small arpack fit card == CPU;
   - the error-budget grid search: ``GridSearchCV(Pipeline(StandardScaler,
     QPCA(svd_solver='full'), KNeighborsClassifier), GRID,
     cv=StratifiedKFold(5))`` on the MNIST-shaped surrogate: every split ≥
     GRID_SCORE_FLOOR, one argkmin launch per fold and none for the refit,
     the refit's predict equal to its steps run one by one, a small search
     card == CPU; then argkmin at the folds' shape (14 000 × 56 000 at
     widths 40 and 61) against its plain version, timed;
   - ``MiniBatchQKMeans(n_clusters=10, batch_size=1024, delta=δ,
     random_state=0)`` for δ in (0, 0.5): two fits with the same bits,
     ARI ≥ MB_ARI_FLOOR, inertia within MB_INERTIA_RTOL of the δ=0
     QKMeans fit's, five ``partial_fit`` calls;
   - ``FeatureHasher(1024)`` over 100 000 dict rows: the card's tensor
     equals the CPU's.
   - the accuracy-vs-quantum-runtime study (``examples/runtime_tradeoff.py``
     at the papers' sizes) under ``obs.enable(<artifact>)``: leg 1 refits
     the δ-sweep with obs on (labels bit-equal to the obs-off fits, the
     same Lloyd launches, both wall clocks printed; one ``tradeoff``
     record per δ with ARI and ``quantum_runtime_model``) and fits q-means
     once at its IPE route; leg 2 fits ``QPCA(61)`` on
     ``load_mnist_surrogate_low_margin(70_000)``, and for ε+δ in
     TRADEOFF_ERRS takes the Gaussian-tomography quantum transform,
     scores a holdout 7-NN (60 000 train rows, 10 000 queries: argkmin at
     10 000 × 60 000 × 61, k=7) against TRADEOFF_ACC_FLOOR and prices the
     point with ``accumulate_q_runtime`` of a 10 000-row twin fit. The
     artifact must validate with 0 schema errors, audit with no flagged
     site and no violation at a ``fail_prob`` 0 site, hold exactly the
     guarantee sites and ledger steps of TRADEOFF_SITES/TRADEOFF_STEPS,
     and ``python -m sq_learn_tpu_torch.obs frontier`` must print the
     table ``obs.frontier.render`` gave.
5. The streaming phase (``sq_learn_tpu_torch.streaming``, ``resilience``,
   ``utils.checkpoint``), each path with the counts set to 0 before it.
   BASELINE #3's fits above already stream under 'auto' (219.5 MB of host
   rows over the 128 MiB cap: ``ingest_ == 'streamed'``), and the δ=0
   fit's streamed predict of the host rows must equal its predict of the
   card tensor bit for bit. Then, at STREAM_TILE_BYTES (16 MiB) tiles:
   - ``streamed_resident_put`` of the surrogate at the default cap and at
     16 MiB, each bit-equal to ``torch.from_numpy(X).to(card)``, GB/s
     beside the pageable upload;
   - ``QPCA(61, svd_solver='full', ingest='streamed')``: the spectrum
     within SPECTRUM_RTOL of float64, the components' subspace against
     the monolithic fit's (principal-angle cosines ≥ SUBSPACE_COS_FLOOR);
     a Gram pass interrupted at tile 7 resumes from its checkpoint at tile
     4, bit-equal; an interrupted fit under ``SQ_STREAM_CKPT_DIR`` resumes
     to the plain fit's bits; ``put_fail:tiles=3/7,times=1`` costs 2
     retries and leaves the fit bit-equal;
   - three consecutive put failures open the breaker: the fit raises
     ``BreakerOpenError`` with no fitted state, the next fit's preflight
     raises, then it is reset;
   - the streamed 7-NN search (10 000 queries, 60 000 × 784, 4 MiB tiles:
     8 tiles, a padded tail) bit-equal to the monolithic search, 8
     ``argkmin_short`` launches at (784, 7), the kernel held and timed at
     the tile's shape (the last entry of the argkmin ``shapes``);
   - checkpoints: the fitted QKMeans, the trial's QPCA and a 7-NN saved
     and loaded on the card, outputs equal; ``examples/streaming_fit.py``'s
     flow on the CICIDS surrogate (``partial_fit`` on 1024-row batches,
     saved after 10, loaded, continued): ``n_steps_`` and
     STREAM_FIT_ARI_FLOOR;
   - item 7: q-means with ``compute_dtype='float16'`` (no Lloyd launch,
     ARI_FLOOR), ``algorithm='elkan'`` at δ=0 (warns, the lloyd fit's
     labels), float64 7-NN under ``default_dtype='float64'`` (no argkmin
     launch, KNN_ACCURACY_FLOOR) and ``QPCA(61, compute_dtype='bfloat16')``
     on the partial-U route (within BF16_SPECTRUM_RTOL of float64).
6. The serving phase (``sq_learn_tpu_torch.serving`` and obs's budget,
   control, probe and report), with both kernels' counts at 0 before it
   and still 0 after it (the serving kernels are plain torch). Tenants on
   the card: alpha (the δ=0 QKMeans above), gamma (the trial's QPCA(61)),
   delta (BASELINE #4's randomized TruncatedSVD(10)), a bf16 twin of
   each, an int8 twin of alpha and SERVE_ALIASES aliases of alpha. Legs:
   the cold start (the first request per (op, bucket, dtype) at
   LADDER_SIZES, unwarmed against warmed); the closed loop (SERVE_REQUESTS
   requests of 1–16 rows, float32 and float64, SERVE_CLIENTS clients of
   SERVE_WINDOW requests in flight, SERVE_CAP rows, SERVE_WAIT_MS ms,
   after ``registry.warm()`` with the
   budgets pinned at 0) batched and sequential, every response held
   against float64 (labels by the margin rule against the estimator's own
   predict, transforms within SERVE_DIST_RTOL/SERVE_PROJ_RTOL, quantized
   responses inside their fold) with 0 aot misses; the same stream again
   with every batch replayed through its kernel on the same padded batch,
   bit for bit; the open loop at SERVE_OPEN_LOOP × the batched QPS; the
   bf16 replay's bytes over the float32 replay's (0.5), live audits
   clean; the breaker (futures fail with BreakerOpenError, no kernel
   runs, the half-open probe closes it); the control leg (static arm
   alerts, the controller's none, at a lower theoretical cost, 0 schema
   errors, ``python -m sq_learn_tpu_torch.obs report|budget|control``
   exit 0); a small tenant card == CPU. Its figures print on a
   ``serving:`` JSON line.
7. The mesh phase (``sq_learn_tpu_torch.parallel``) on
   ``make_mesh(["cuda:0"] * 4)``, four logical shards of the card. First
   both kernels at the shard shapes, held against their plain versions
   and timed (the Lloyd step at 17 500 × 784, k=10, R=1, window 0 and
   0.5; the search at 10 000 × 15 000 × 784, k=7); then, with the counts
   at 0: the sharded k-means++ init's indices equal to the single-device
   init's from the same generator; BASELINE #3's δ=0 fit (n_init=10, no
   init subsample) on the mesh against the single-device fit (ARI 1.0,
   inertia within MESH_INERTIA_RTOL; from an array init the labels and
   ``n_iter`` equal too, the init one row of each class); the δ=0.5 δ-means fit on the mesh (ARI_FLOOR
   against the classes and the single-device fit); QPCA(61) on the trial's
   data (spectrum within SPECTRUM_RTOL of float64, the Gaussian
   tomography of the top-k vectors and of the transform within δ); 7-NN
   on 60 000 rows predicting 10 000 (the single-device lists, exactly one
   ``argkmin_short`` launch per shard per search); TruncatedSVD(10) on the
   covertype surrogate (within 3 × JAX_MESH_SVD_ERR of float64); the
   streamed sharded Gram at STREAM_TILE_BYTES with one retried tile
   (bit-equal to a clean pass); a one-process NCCL world, whose
   ``global_mesh()`` δ=0 fit is bit-equal to the in-process 1-shard
   mesh's; and, where more than one card is visible, the δ=0 fits and
   the 7-NN search over every card, in this process and as a world of
   one process per card over NCCL, bit-equal to as many shards on cuda:0.
   Each fit prints its wall clock, its launches per shard and the mesh
   over single-device ratio. The ``kernels`` line files the 4-shard
   runs' launches under the mesh-shard shapes; every other run of the
   phase joins only the kernels' totals.
8. The elastic phase (``sq_learn_tpu_torch.parallel.elastic``,
   ``obs.fleet``) over a shard store of
   ``synthetic_surrogate(100_000, 784, 10, seed=784)`` (38 shards): the
   window-synchronous q-means fold (k=10, 2 epochs, windows of 4, seed
   0). First the Lloyd kernel at the certification's shard shape (4 × 5,
   k=3, R=1, δ=0.4) against its plain version, timed; then
   ``shard_partial`` on the card against its CPU run on three shards
   (counts and labels equal, sums and inertia within
   ELASTIC_PARTIAL_RTOL); ``elastic_fit_local`` on the card at 1, 2 and
   3 hosts and with ELASTIC_FAULT (3 → 2 hosts): the same state bit for
   bit; a real 2-worker ``ElasticCoordinator`` fit and a 3-worker one
   with worker 1 SIGKILLed after the first commit (generation 1 of
   members [0, 2], a ``host_fail`` record with ``detect_s``): both
   bit-equal to the simulator, every shard folded twice; ``python -m
   sq_learn_tpu_torch.obs fleet`` over the killed run's shards (exit 0,
   one run id, a monotone merge, every committed window once, generation
   1's critical path, the killed worker's flushed progress, every shard
   valid). The workers' certification launches of the Lloyd kernel,
   reported by each worker, join the ``kernels`` line. Its figures print
   on an ``elastic:`` JSON line.
9. The digits phase, BASELINE #1 (``BASELINE.md`` row 1, ``bench.py``'s
   headline fit), under DIGITS_PHASE_S seconds: sklearn's digits (1797 ×
   64) through the port's ``load_digits`` (its own copy of the data:
   shape, dtypes, labels 0–9, ``X.sum()`` == DIGITS_X_SUM); the Lloyd
   kernel at 1797 × 64, k=10, R=10 (an unaligned row count) against its
   plain version at window 0 and 0.5, as in phase 2, and timed; then,
   with the counts at 0, ``QKMeans(n_clusters=10, n_init=10,
   max_iter=300, delta=0.5, true_distance_estimate=False,
   random_state=0)``: one warm-up fit with obs on, DIGITS_FITS timed fits
   (``fit_s`` their minimum; the same labels; Lloyd launches in each), one
   more with obs on for the record; δ=0 from the classes' means on the
   card against the CPU (labels and ``n_iter_`` equal, inertia within
   DIGITS_INERTIA_RTOL); the δ=0.5 fits of seeds 0–2 against the δ=0 fit
   of seed 0 (median ARI ≥ DIGITS_ARI_FLOOR, median inertia ratio ≤
   DIGITS_INERTIA_CEIL); ``obs.regress.selftest(device="cuda")`` (the
   clean rerun green with ``peak_hbm_bytes`` measured, the doubled upload
   red on transfer bytes and peak memory) and ``python -m
   sq_learn_tpu_torch.obs regress`` on the phase's record against a temp
   root holding the warm-up's (exit 0, no red). The phase's Lloyd
   launches join the ``kernels`` line under the digits shape; its
   figures print on a ``digits:`` JSON line. It runs after every main
   path but the examples phase and the profiling phase's fit.
10. The examples phase, under EXAMPLES_PHASE_S seconds: every driver of
    ``examples_torch/`` (the port's counterparts of ``examples/``)
    through its ``main(argv)`` in this process on the card, at the JAX
    drivers' defaults (``mnist_trial`` at 10 000 × 784, 61 components)
    but ``qpca_error_tradeoff --subsample 4000 --folds 3`` and
    ``sharded_fit --shards 4`` (and over every card where there are
    more), each with the counts set to 0 before it. A driver that raises
    or exits non-zero (``runtime_tradeoff``'s audit flag included) fails
    the run; so does a quality number under its floor, the JAX driver's
    own number at the same arguments less a stated margin (the EX_*
    constants: the δ-sweep's and the runtime study's ARIs, the CV and
    holdout accuracies, P(err ≤ δ), the stream's steps, the sharded
    5-NN accuracy), and a resumed stream that does not end bit-equal to
    one uninterrupted ingest of the same file. Both kernels are held
    against their plain versions, and timed, at the shapes the drivers
    launch them at (Lloyd at 20 000 × 78, 3 072 × 32 and a 1 001-row
    shard; argkmin at the CV folds' 9 000 × 1 000 × 61, 2 666 × 1 334
    at widths 61 and 10, the holdout's 1 536 × 1 536 × 8 and a 450-row
    shard at 64), and the drivers' launches join the ``kernels`` line
    under those shapes. The drivers' lines print indented; the phase's
    figures print on an ``examples:`` JSON line.
11. Print the card, a ``kernels`` JSON line and, last, the ``ok`` line.
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
PROFILING_PHASE_S = 30.0  # the profiling phase's limit, seconds
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
# the search must take under this share of its plain version's time at
# the main shape (the first design took 0.54)
ARGKMIN_PLAIN_RATIO = 0.5
# the qPCA trial, examples/mnist_trial.py at --subsample 0: qPCA at
# ε = δ = 0.4, the quantum transform, a 10-fold CV of 7-NN on its output
QPCA_COMPONENTS, QPCA_EPS, QPCA_DELTA, QPCA_THETA = 61, 0.4, 0.4, 1e-9
# explained_variance_ of the kept components against a float64 Gram route
# in the same run: 3× the JAX package's own float32 error at 70 000 × 784,
# 5.079681150339217e-05 (largest relative error of its 61 values; measured
# on a CPU by `python tests/test_torch_qpca.py`)
SPECTRUM_RTOL = 3 * 5.079681150339217e-05
# the small card-vs-CPU fit: QPCA(16) on synthetic_surrogate(4000, 64, 10,
# seed=784) at ε = δ = 0, compared in norm: ‖card − cpu‖ ≤ rtol·‖cpu‖
SMALL_QPCA_RTOL = 1e-4
# q-means' κ against κ from a float64 eigvalsh of the float64 Gram of the
# same rows: 3× the JAX package's float32 error on a CPU, measured by
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_qkmeans_quantum.py`
# (exact route: σ_min of the 70 000 × 784 Gram; sketch route: λ_min of the
# scaled Gram of the 4096 rows a fit at random_state=0 samples)
EXACT_KAPPA_RTOL = 3 * 0.007497313154634644
SKETCH_KAPPA_RTOL = 3 * 0.003745695597914574
SKETCH_ROWS = 4096
# ARI floors of q-means' quantum modes: the JAX package's ARI on
# synthetic_surrogate(7000, 784, 10, seed=784) at the same parameters, on a
# CPU (same script), less 0.05
IPE_ARI_FLOOR = 1.0 - 0.05
TOMOGRAPHY_ARI_FLOOR = 1.0 - 0.05
# QLSSVC on classes 0 and 1 of the surrogate as ±1, 8000 training and 2000
# test rows from a permutation seeded with 0: classical_predict accuracy at
# least the JAX package's on the same split less 0.01, and the singular
# values of F and cond_ within 3× the JAX package's float32 error against a
# float64 decomposition of the same F; both measured on a CPU by
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_qlssvc.py`
QLSSVC_TRAIN, QLSSVC_TEST = 8000, 2000
JAX_QLSSVC = {
    "linear": {"accuracy": 1.0, "sv_rel_err": 8.726667515270002,
               "cond_rel_err": 41.23110782082795},
    "rbf": {"accuracy": 1.0, "sv_rel_err": 0.00017489251146443515,
            "cond_rel_err": 4.155346845042398e-07},
}
SMALL_QLSSVC_RTOL = 1e-4  # the 500-row fit on the card against the CPU
# BASELINE #5, examples/delta_tradeoff.py at --n-samples 50000: the CICIDS
# surrogate (50 000 × 78, 6 classes) standardized, then δ-means q-means
# with k=6, n_init=10 at each δ. The Lloyd kernel runs at 50 000 × 78,
# k=6, R=10: 312-byte rows, not 16-byte aligned.
SWEEP_N, SWEEP_M, SWEEP_K = 50_000, 78, 6
SWEEP_DELTAS = (0.0, 0.1, 0.3, 0.5, 1.0)
# The JAX package's ARI at random_state=0 (its labels scored by sklearn's
# ARI: its own adjusted_rand_score overflows int32 past 46 341 samples and
# reads 0.88364 and 0.86252 at δ=0.5 and 1.0), and the largest drop below
# it among 20 fits on a CPU (random_state 0–9 of the JAX package and of
# the port: the Gumbel streams differ, so the card's fit is one more draw
# from that spread). Both measured by `PYTHONPATH=. JAX_PLATFORMS=cpu
# python tests/test_torch_baselines.py`. δ=0.3 spreads most: at some
# seeds the tight pair merges for good.
JAX_SWEEP_ARI = {0.1: 0.9999521388312199, 0.3: 0.9926016792421699,
                 0.5: 0.8278957695391554, 1.0: 0.796734141497832}
SWEEP_ARI_DROP = {0.1: 0.0, 0.3: 0.08189553533719529,
                  0.5: 0.022162069117578564, 1.0: 0.0043493320148193515}
# the margin: 1.5 × that drop, and at least 0.005
SWEEP_MARGIN = {d: max(1.5 * drop, 0.005)
                for d, drop in SWEEP_ARI_DROP.items()}
# BASELINE #4: TruncatedSVD(n_components=10, n_iter=5, random_state=0) on
# the covertype surrogate (581 012 × 54). singular_values_ within 3× the
# JAX package's float32 error against a float64 spectrum of the same data
# (same script): randomized 9.055416292452883e-07, arpack
# 3.49901462968096e-06
COVTYPE_N, COVTYPE_M, SVD_K = 581_012, 54, 10
JAX_SVD_ERR = {"randomized": 9.055416292452883e-07,
               "arpack": 3.49901462968096e-06}
ORTHONORMAL_ATOL = 1e-4
# the error-budget grid search on the MNIST-shaped surrogate: every split
# must score at least this (the classes are far apart)
GRID = {"pca__n_components": [40, 61], "knn__n_neighbors": [5, 7]}
GRID_FOLDS = 5
GRID_SCORE_FLOOR = 0.95
SMALL_GRID_ATOL = 1e-6  # cv_results_ of the small search, card against CPU
# mini-batch q-means at 70 000 × 784: ARI against the labels, and inertia_
# within 10 % of the δ=0 QKMeans fit's on the same X
# (tests/test_minibatch.py:240's own tolerance)
MB_BATCH, MB_ARI_FLOOR, MB_INERTIA_RTOL = 1024, 0.95, 0.10
# the streaming phase: a 16 MiB tile cap makes each 70 000 × 784 pass run
# 14 tiles (5 349 rows each, a tail bucketed to 4 096 rows); the streamed
# 7-NN search runs its 10 000 queries at a 4 MiB cap (8 tiles of 1 337,
# a tail of 641 padded to 1 024)
STREAM_TILE_BYTES = 16 << 20
KNN_TILE_BYTES = 4 << 20
# the streamed fit's components against the monolithic fit's: the cosines
# of the principal angles between the two 61-dimensional subspaces
SUBSPACE_COS_FLOOR = 1 - 1e-4
# the bfloat16 partial-U route's explained_variance_ against float64: 3×
# the JAX package's own error on that route at 70 000 × 784 with 61
# components (``JAX_PLATFORMS=cpu python tests/test_torch_qpca.py``)
BF16_SPECTRUM_RTOL = 3 * 0.00015576145127386732
# examples/streaming_fit.py's flow on the CICIDS surrogate: partial_fit on
# 1024-row batches, a save after 10, a load, the rest. One pass of
# MiniBatchQKMeans(6, delta=0.3) over the standardized rows: the JAX
# package's lowest ARI over random_state 0–9 is 0.7733481366199509 (``python
# tests/test_torch_checkpoint.py``), less a margin of 0.05
STREAM_FIT_CLUSTERS, STREAM_FIT_SAVE_AFTER = SWEEP_K, 10
STREAM_FIT_ARI_FLOOR = 0.7733481366199509 - 0.05
HASH_ROWS, HASH_FEATURES = 100_000, 1024
# the accuracy-vs-quantum-runtime study, examples/runtime_tradeoff.py at the
# papers' sizes. Leg 1 is the δ-sweep above with obs on, plus one fit at
# q-means' IPE route; leg 2 is the qPCA ε+δ sweep of
# examples/qpca_error_tradeoff.py:36 on the low-margin MNIST surrogate
# (70 000 × 784), a holdout 7-NN on the first 60 000 rows and the QADRA
# accountant of a twin fit of the first 10 000 rows at ε = δ = (ε+δ)/2
TRADEOFF_IPE_DELTA = 0.5
TRADEOFF_N, TRADEOFF_TRAIN, TRADEOFF_TWIN = 70_000, 60_000, 10_000
TRADEOFF_COMPONENTS, TRADEOFF_KNN = 61, 7
TRADEOFF_ERRS = (0.2, 0.8, 1.6, 3.2)
# the holdout accuracy floors: the JAX package's lowest accuracy over
# QPCA random_state 0-9 (the tomography noise) at the same sizes, less 1.5×
# its spread (highest − lowest), measured on a CPU by `PYTHONPATH=.
# JAX_PLATFORMS=cpu python tests/test_torch_obs_tradeoff.py`; its
# accuracies were 0.9905–0.9906, 0.9904–0.9907, 0.9904–0.9907 and
# 0.9904–0.9906 (the Gaussian noise of ε+δ spread over 70 000 × 61
# entries barely moves the 7-NN vote)
TRADEOFF_ACC_FLOOR = {0.2: 0.9903500000000001, 0.8: 0.9899499999999999,
                      1.6: 0.9899499999999999, 3.2: 0.9900999999999998}
# the band of the transform's realized ‖Xq − X·Vᵀ‖_F over its bound
# √k·(ε+δ): the JAX package's lowest and highest ratio over the same runs
# (0.57700–0.57758, near 1/√3: the noise is near-uniform on ±bound/√d
# per entry), widened by 1.5× their spread on each side (same script). A
# transform that adds no noise, or noise of another scale, falls outside
# it, where the accuracy does not see the noise
TRADEOFF_FNORM_BAND = {0.2: (0.5763908474730872, 0.5782434929282396),
                       0.8: (0.5763223730071687, 0.5781183920441417),
                       1.6: (0.5766555111095377, 0.5781409243217259),
                       3.2: (0.5768526923871267, 0.5778809731937964)}
# the guarantee sites and ledger (estimator, step) pairs both legs record:
# what the JAX package's accelerator route records for the same legs at a
# small size with the same routes (the sketch engaged in leg 1, exact in
# the twin fit), pinned by tests/test_torch_obs_tradeoff.py
TRADEOFF_SITES = frozenset({
    "consistent_phase_estimation", "ipe", "phase_estimation",
    "qkmeans.delta_window", "qpca.sv_estimate", "sketch.mu", "sketch.stats",
    "tomography.gaussian"})
TRADEOFF_STEPS = frozenset({("knn", "search"), ("qkmeans", "fit"),
                            ("qpca", "topk_extract")})


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
        # a Python int: the products below pass int64 past ~3·10⁶ rows
        return int((v * (v - 1) // 2).sum())

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


def roofline(nbytes, ops, math="fp32"):
    """(bound_ms, bound_by) of work that must move ``nbytes`` and do
    ``ops`` operations in ``math``, against the H100's published peaks
    (``sq_learn_tpu_torch.utils.profiling``, the port's one table)."""
    from sq_learn_tpu_torch.utils.profiling import (H100_SXM_HBM_BYTES_PER_S,
                                                    H100_SXM_PEAK_FLOPS)

    bytes_ms = nbytes / H100_SXM_HBM_BYTES_PER_S * 1e3
    ops_ms = ops / H100_SXM_PEAK_FLOPS[math] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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


def lloyd_operands(Xc, k, r, torch):
    """The operands of a Lloyd launch on the centered rows ``Xc``: unit
    weights, row norms, r × k centers drawn from the rows, one shared
    Gumbel operand, the min_d2 tolerance, and the exact (float64)
    distances of the float32 operands with each row's two smallest:
    where a label is decided and how near each row lies to a deciding
    boundary. Also prints how many rows the δ-window leaves a choice."""
    import numpy as np

    dev = Xc.device
    n = Xc.shape[0]
    w = torch.ones(n, device=dev)
    xsq = torch.sum(Xc * Xc, dim=1)
    rng = np.random.default_rng(0)
    C = Xc[torch.from_numpy(rng.choice(n, (r, k))).to(dev)]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    gum = torch.empty((r, n, k), device=dev).exponential_(
        generator=g).log_().neg_()
    csq = torch.sum(C * C, dim=-1)
    tol = D2_RTOL * (xsq[None, :] + csq.max(dim=1).values[:, None])
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
    print(f"{n}×{Xc.shape[1]}, k={k}, R={r}: rows with two or more centers "
          f"in the δ-window: {in_window} of {r * n} at window {WINDOW}; "
          f"wide window {wide:.4f} (the {WIDE_WINDOW_QUANTILE} quantile of "
          f"the nearest-center gap)", flush=True)
    return {"w": w, "xsq": xsq, "C": C, "gum": gum, "tol": tol,
            "d2_exact": d2_exact, "top2": top2, "wide": wide}


def hold_lloyd_cases(cases, operands, torch):
    """Hold the Lloyd kernel against its plain version in each case
    (name, X, Gumbel operand, window, timed) on the operands of
    :func:`lloyd_operands`: labels against the exact decision and the
    plain version's up to the float32 margin, min_d2, sums, counts and
    inertia at their tolerances, two launches bit-equal; the timed cases
    are also timed against the plain version and the bound. Returns the
    timed cases' results by (name, window)."""
    from sq_learn_tpu_torch.ops.kernels import (lloyd_step,
                                                lloyd_step_reference,
                                                lloyd_step_work)

    w, xsq, C, tol = (operands[name] for name in ("w", "xsq", "C", "tol"))
    d2_exact, top2, wide = (operands[name]
                            for name in ("d2_exact", "top2", "wide"))
    dev = C.device
    R, K = C.shape[:2]
    N, M = w.shape[0], C.shape[2]
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
            bound_ms, bound_by = roofline(
                *lloyd_step_work(N, M, K, R, Xk.dtype, window),
                math="bf16" if Xk.dtype == torch.bfloat16 else "fp32")
            report[(name, window)] = {
                "flips": flips, "err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
            line += (f"; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                     f"{bound_ms:.4f} ms by {bound_by})")
        print(line, flush=True)
    return report


def kernel_phase(Xc, torch):
    """Hold the Lloyd kernel against its plain version at the slice
    shape; returns the kernel's JSON entry (launches filled in later)."""
    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    dev = Xc.device
    operands = lloyd_operands(Xc, K, R, torch)
    w, xsq, C, gum, wide = (operands[name]
                            for name in ("w", "xsq", "C", "gum", "wide"))
    # (name, X, Gumbel operand, window, timed)
    cases = [("float32", Xc, None, 0.0, True),
             ("float32", Xc, gum, WINDOW, True),
             ("float32", Xc, gum, wide, False),
             ("bfloat16", Xc.to(torch.bfloat16), None, 0.0, True)]
    report = hold_lloyd_cases(cases, operands, torch)
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
    entry = {"name": "lloyd_step", "route": "cuda",
             "source": "sq_learn_tpu_torch/csrc/lloyd.cu",
             "replaces": "sq_learn_tpu/ops/pallas_kernels.py:117",
             "launches": None,
             "max_abs_err": max(main["err"].values()),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": None}
    return entry, (w, xsq, C, gum)


def kernel_symbols(here, name):
    """The names of the ``__global__`` functions of ``csrc/<name>.cu``
    (the profiler prints a template's as ``name<T>(...)``)."""
    import re

    with open(os.path.join(here, "sq_learn_tpu_torch", "csrc",
                           f"{name}.cu")) as fh:
        return set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*"
            r"[(<]", fh.read()))


def profiling_phase(Xc, Xd, lloyd_ops, lloyd_ms, knn_ms, smi, here, torch):
    """``utils.profiling`` and ``show_versions`` on the card, through both
    kernels at the kernel phase's operands: synced ``benchmark`` medians
    against the phase's CUDA-event medians, ``mfu`` against the H100's
    fp32 peak, and a ``trace`` whose CUDA kernel events name each
    kernel's ``__global__`` functions. Returns the phase's JSON figures;
    its launches (benchmark repeats and the traced ones, no main-path
    run) are in them and join no count of the ``kernels`` line.
    :func:`profiling_fit` finishes the phase after every main path."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from sq_learn_tpu_torch import show_versions
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step
    from sq_learn_tpu_torch.utils.profiling import (benchmark,
                                                    device_peak_flops,
                                                    lloyd_iter_flops,
                                                    matmul_flops, mfu, trace)

    t_phase = time.perf_counter()
    lloyd_step.launches = argkmin.launches = 0
    out = {"math": "fp32"}
    # the debug report, with CUDA up: the card nvidia-smi names and the
    # CUDA torch was built with
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        show_versions()
    report = buf.getvalue()
    card = smi.split(",")[0].strip()
    check(card in report and f"torch CUDA: {torch.version.cuda}" in report,
          f"show_versions names neither the card {card!r} nor CUDA "
          f"{torch.version.cuda}: {report!r}")
    print(report, flush=True)
    peak = device_peak_flops()
    check(peak is not None, f"device_peak_flops() does not resolve on "
                            f"{card}")
    out["peak_flops"] = peak

    # each kernel: the synced wall-clock median of benchmark() against the
    # kernel phase's CUDA-event median, and its MFU
    w, xsq, C, gum = lloyd_ops
    T, Q = Xd[:N_TRAIN].contiguous(), Xd[N_TRAIN:].contiguous()
    tsq = torch.sum(T * T, dim=1)
    cases = (("lloyd_step", lloyd_ms, R * lloyd_iter_flops(N, M, K),
              lambda: lloyd_step(Xc, w, xsq, C, gumbel=gum, window=WINDOW)),
             ("argkmin", knn_ms, matmul_flops(N - N_TRAIN, M, N_TRAIN),
              lambda: argkmin(T, tsq, Q, KNN_K)))
    for name, event_ms, flops, call in cases:
        median, _ = benchmark(call, repeats=REPS, name=name)
        median_ms = median * 1e3
        check(0.9 * event_ms <= median_ms <= 2.0 * event_ms + 1.0,
              f"{name}: benchmark's synced median {median_ms} ms is not "
              f"within [0.9, 2] × the CUDA-event median {event_ms} ms (+1 "
              f"ms)")
        share = mfu(flops, median)
        check(share is not None and 0.0 < share <= 1.05,
              f"{name}: mfu {share} outside (0, 1.05]")
        out[name] = {"median_ms": median_ms, "event_ms": event_ms,
                     "flops": flops, "mfu": share}
        print(f"profiling {name}: benchmark median {median_ms:.4f} ms "
              f"(CUDA events {event_ms:.4f} ms), {flops:.6g} FLOPs, mfu "
              f"{share:.4f} against {peak:.4g} FLOP/s ({out['math']})",
              flush=True)

    tmp = tempfile.mkdtemp(prefix="sq_profiling_")
    try:
        # the profiler sees both kernels through their ctypes binding
        with trace(os.path.join(tmp, "trace")) as handle:
            lloyd_step(Xc, w, xsq, C, gumbel=gum, window=WINDOW)
            argkmin(T, tsq, Q, KNN_K)
        with open(handle.path) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        seen = {}
        for source in ("lloyd", "argkmin"):
            symbols = kernel_symbols(here, source)
            # e.g. "void (anonymous namespace)::lloyd_score<float>(...)"
            seen[source] = sorted(
                s for s in symbols
                if any(re.search(rf"(^|[\s:]){s}[(<]", n) for n in names))
            check(seen[source], f"the trace's CUDA kernel events name no "
                                f"__global__ function of csrc/{source}.cu "
                                f"({sorted(symbols)}); kernels seen: "
                                f"{sorted(names)}")
        out["trace_kernels"] = seen
        print(f"profiling trace: {len(events)} events, kernels of the "
              f"hand-written sources {seen}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = (lloyd_step.launches, argkmin.launches)
    check(min(launches) > 0, f"the profiling phase launched (lloyd_step, "
                             f"argkmin) {launches} times")
    out["benchmark_and_trace_launches"] = {"lloyd_step": launches[0],
                                           "argkmin": launches[1]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def profiling_fit(X, out, here):
    """The profiling phase's last part, run after every main path so that
    the main path's fit stays the process's first: BASELINE #3's δ-means
    fit under ``Timer(name="profiling.qkmeans_fit")`` with obs on, whose
    span lands, whose ``obs.snapshot()["measured_mfu"]`` equals the
    ``profiling.mfu`` gauge and whose obs report prints the "measured
    MFU" line. Adds its figures and seconds to ``out``; returns its Lloyd
    launches, the only ones of the phase that join the ``kernels``
    line."""
    import shutil
    import tempfile

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.ops.kernels import lloyd_step
    from sq_learn_tpu_torch.utils.profiling import (Timer, lloyd_iter_flops,
                                                    mfu)

    t_part = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sq_profiling_")
    try:
        art = os.path.join(tmp, "profiling.jsonl")
        obs.enable(art)
        est = QKMeans(n_clusters=K, n_init=10, max_iter=300, delta=WINDOW,
                      true_distance_estimate=False, sketch=0,
                      random_state=0)
        before = lloyd_step.launches
        with Timer(name="profiling.qkmeans_fit") as timer:
            est.fit(X)
        fit_launches = lloyd_step.launches - before
        # every launch runs R restarts (inactive ones masked): the Lloyd
        # FLOPs the launches could do, a share of the fit's whole work
        fit_mfu = mfu(fit_launches * R * lloyd_iter_flops(N, M, K),
                      timer.elapsed)
        rec = obs.get_recorder()
        snap = obs.snapshot()
        spans = [sp for sp in rec.spans
                 if sp["name"] == "profiling.qkmeans_fit"]
        gauge = rec.gauges.get("profiling.mfu")
        obs.disable()
        check(len(spans) == 1 and spans[0]["synced"],
              f"the fit's Timer span did not land: {spans}")
        check(fit_launches > 0 and gauge == fit_mfu
              and snap["measured_mfu"] == round(float(gauge), 6),
              f"measured_mfu {snap['measured_mfu']} against the gauge "
              f"{gauge} (launches {fit_launches})")
        env = dict(os.environ, PYTHONPATH=here)
        cli = subprocess.run(
            [sys.executable, "-m", "sq_learn_tpu_torch.obs", "report", art],
            cwd=here, env=env, capture_output=True, text=True, timeout=120)
        check(cli.returncode == 0 and "measured MFU" in cli.stdout,
              f"obs report exited {cli.returncode} without the measured "
              f"MFU line: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
        line = [ln for ln in cli.stdout.splitlines() if "measured MFU" in ln]
        out["fit"] = {"wall_s": timer.elapsed, "launches": fit_launches,
                      "mfu": fit_mfu, "measured_mfu": snap["measured_mfu"],
                      "report_line": line[0].strip()}
        print(f"profiling fit: {timer.elapsed:.4f} s, {fit_launches} Lloyd "
              f"launches, mfu {fit_mfu:.6f}; obs report: {line[0].strip()}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] += time.perf_counter() - t_part
    check(out["phase_s"] < PROFILING_PHASE_S,
          f"the profiling phase took {out['phase_s']} s, not under "
          f"{PROFILING_PHASE_S} s")
    return fit_launches


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
    from sq_learn_tpu_torch.ops.kernels import (argkmin, argkmin_plan,
                                                argkmin_reference,
                                                argkmin_route, argkmin_tiles,
                                                argkmin_work)

    dev = Xd.device
    T, Q = Xd[:N_TRAIN].contiguous(), Xd[N_TRAIN:].contiguous()
    # small integers: every product and sum is exact in float32, so scores
    # tie exactly and often, and the kernel must give the plain lists
    Ti = torch.round(T / 8.0).contiguous()
    Qi = torch.round(Q / 8.0).contiguous()
    routes = {k: argkmin_route(k, dev) for k in (KNN_K, 100, K_GLOBAL)}
    check(routes == {KNN_K: "short", 100: "shared", K_GLOBAL: "global"},
          f"k={KNN_K} must take the short-list kernel, k=100 the long-list "
          f"kernel with lists in shared memory and k={K_GLOBAL} the one "
          f"with lists in global memory, not {routes}")
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
        tiles = argkmin_tiles(k, dev)
        splits, rows = argkmin_plan(nq, nt, k, n_sms, tiles)
        line = (f"argkmin {case}: {argkmin_route(k, dev)} route, tiles "
                f"{tiles}, {splits} train splits of {rows} rows; "
                f"{flips_plain} of {nq * k} indices differ from the "
                f"plain version, max |d2 − plain| {err}; {held}")
        if timed:
            ms = time_ms(lambda: argkmin(Tk, tsq, Qk, k))
            plain_ms = time_ms(lambda: argkmin_reference(Tk, tsq, Qk, k))
            check(ms < ARGKMIN_PLAIN_RATIO * plain_ms,
                  f"argkmin {case}: {ms} ms, not under {ARGKMIN_PLAIN_RATIO} "
                  f"× the plain version's {plain_ms} ms")
            torch.backends.cuda.matmul.allow_tf32 = False
            products_ms = time_ms(lambda: torch.matmul(Qk, Tk.T))
            print(f"argkmin products_ms: torch.matmul(Q, T.T) at "
                  f"{nq}×{nt}×{Tk.shape[1]} in float32 with "
                  f"torch.backends.cuda.matmul.allow_tf32 = False: "
                  f"{products_ms:.4f} ms (a yardstick for the products, "
                  f"not library_ms)", flush=True)
            bound_ms, bound_by = roofline(*argkmin_work(nq, nt, Tk.shape[1],
                                                        k))
            entry = {"name": "argkmin", "route": "cuda",
                     "source": "sq_learn_tpu_torch/csrc/argkmin.cu",
                     "replaces": "sq_learn_tpu/ops/pallas_kernels.py:305",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "products_ms": products_ms}
            line += (f"; {ms:.4f} ms (plain {plain_ms:.4f} ms, products "
                     f"{products_ms:.4f} ms, bound {entry['bound_ms']:.4f} "
                     f"ms by {entry['bound_by']})")
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


def multinomial_tree(torch):
    """The multinomial split tree on the card: one ``torch.binomial`` call
    per level, ⌈log₂ d⌉ levels, at the trial's vector lengths; counts sum
    to N, and each call is timed (CUDA events)."""
    import math

    from sq_learn_tpu_torch.ops.quantum.sampling import multinomial_counts
    from sq_learn_tpu_torch.ops.quantum.tomography import \
        tomography_n_measurements

    g = torch.Generator(device=CARD)
    g.manual_seed(0)
    for rows, d in ((1, 784), (1, N), (QPCA_COMPONENTS, N),
                    (QPCA_COMPONENTS, 2 * N)):
        p = torch.rand((rows, d), generator=g, device=CARD) ** 4
        n = tomography_n_measurements(min(d, N), QPCA_DELTA)
        before = multinomial_counts.binomial_calls
        counts = multinomial_counts(g, n, p)
        calls = multinomial_counts.binomial_calls - before
        check(calls == math.ceil(math.log2(d)),
              f"multinomial tree at d={d}: {calls} binomial calls, not "
              f"⌈log₂ d⌉ = {math.ceil(math.log2(d))}")
        check(bool((counts.sum(-1) == n).all()) and bool((counts >= 0).all()),
              f"multinomial tree at d={d}: counts do not sum to N={n}")
        ms = time_ms(lambda: multinomial_counts(g, n, p), reps=5)
        print(f"multinomial_counts ({rows} × {d}, N={n}): {calls} "
              f"torch.binomial calls (⌈log₂ d⌉ levels), {ms:.4f} ms",
              flush=True)


def qpca_trial_path(X, y, torch):
    """The reference's MNIST trial through the entry points a user calls:
    qPCA with every top-k estimator, the quantum transform, a 10-fold
    stratified CV of 7-NN on the transformed rows, then a true-tomography
    top-k extraction at the full shape. Returns the argkmin launches of
    the CV and the fitted QPCA."""
    import numpy as np

    from sq_learn_tpu_torch.model_selection import (StratifiedKFold,
                                                    cross_validate)
    from sq_learn_tpu_torch.models import QPCA, KNeighborsClassifier
    from sq_learn_tpu_torch.ops.kernels import (argkmin, argkmin_reference,
                                                argkmin_route, argkmin_work)
    from sq_learn_tpu_torch.ops.quantum.estimation import \
        consistent_phase_intervals
    from sq_learn_tpu_torch.ops.quantum.sampling import multinomial_counts

    fit_kw = dict(estimate_all=True, eps=QPCA_EPS, delta=QPCA_DELTA,
                  theta_major=QPCA_THETA, true_tomography=False)
    fits, walls = [], []
    for seed in (0, 1):
        t0 = time.perf_counter()
        fits.append(QPCA(n_components=QPCA_COMPONENTS, svd_solver="full",
                         random_state=seed).fit(X, **fit_kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pca = fits[0]
    t0 = time.perf_counter()
    Xq = pca.transform(X, classic_transform=False,
                       use_classical_components=False)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    Xc = pca.transform(X)
    f_dev = float(torch.linalg.norm(Xq - Xc))
    check(tuple(Xq.shape) == (N, QPCA_COMPONENTS)
          and bool(torch.isfinite(Xq).all()),
          f"quantum transform: shape {tuple(Xq.shape)} or not finite")
    check(pca.topk == QPCA_COMPONENTS,
          f"top-k extraction kept {pca.topk} of {QPCA_COMPONENTS}")
    print(f"QPCA(n_components={QPCA_COMPONENTS}, svd_solver='full').fit(X, "
          f"estimate_all=True, eps={QPCA_EPS}, delta={QPCA_DELTA}, "
          f"theta_major={QPCA_THETA}, true_tomography=False) {N}×{M}: "
          f"{walls[0]:.4f} s (random_state=1: {walls[1]:.4f} s); quantum "
          f"transform {transform_s:.4f} s; topk {pca.topk}; muA "
          f"{pca.muA} ({pca.norm_muA}); sketch_info_ {pca.sketch_info_}; "
          f"‖Xq − Xc‖_F {f_dev}", flush=True)
    check(pca.sketch_info_["sketched"]
          and pca.sketch_info_["sample_rows"] == 4096,
          f"μ(A) sketch: {pca.sketch_info_}")

    # spectrum against a float64 Gram route in this run
    X64 = torch.from_numpy(X).to(CARD).double()
    X64 -= X64.mean(dim=0)
    ev64 = torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:QPCA_COMPONENTS]
    ev64 = (ev64 / (N - 1)).cpu().numpy()
    del X64
    rel = np.abs(pca.explained_variance_ - ev64) / ev64
    check(rel.max() <= SPECTRUM_RTOL,
          f"explained_variance_ off the float64 reference by {rel.max()} "
          f"(relative), beyond {SPECTRUM_RTOL}")
    print(f"explained_variance_ of {QPCA_COMPONENTS} components against "
          f"float64: largest relative error {rel.max()} at component "
          f"{int(rel.argmax())} (limit {SPECTRUM_RTOL})", flush=True)

    # σ̂ on consistent PE's snap grid, decoded as the fit decodes it
    eps_scaled = QPCA_EPS / pca.muA
    iv, _ = consistent_phase_intervals(eps_scaled, 1.0 - 1.0 / M)
    iv = torch.as_tensor(iv, dtype=torch.float32, device=CARD)
    mids = torch.clamp((iv[:-1] + iv[1:]) / 2, min=0.0)
    grid = torch.sort(torch.cos(mids * (eps_scaled + np.pi) / 2.0)
                      * pca.muA).values.cpu().numpy()
    est = pca.estimate_s_values
    pos = np.clip(np.searchsorted(grid, est), 1, len(grid) - 1)
    off = np.minimum(np.abs(est - grid[pos - 1]), np.abs(est - grid[pos]))
    check(bool((off <= 4 * np.finfo(np.float32).eps * est).all()),
          f"σ̂ off consistent PE's snap grid by up to {off.max()}")
    agree = float(np.mean(est == fits[1].estimate_s_values))
    sv_err = float(np.abs(est - pca.singular_values_).max())
    print(f"σ̂: all {len(est)} on the snap grid ({len(grid)} points, "
          f"ε/μ = {eps_scaled}); largest |σ̂ − σ| {sv_err}; random_state 0 "
          f"and 1 agree on {agree:.4f} of σ̂", flush=True)
    for side, est_v, true_v in (
            ("right", pca.estimate_right_sv, pca.components_),
            ("left", pca.estimate_left_sv, pca.left_sv)):
        err = np.linalg.norm(est_v - true_v, axis=1)
        check(err.max() <= QPCA_DELTA,
              f"Gaussian tomography of the {side} vectors: a row off by "
              f"{err.max()} > δ = {QPCA_DELTA}")
        print(f"Gaussian tomography, {side} vectors {est_v.shape}: largest "
              f"row error {err.max()} (δ = {QPCA_DELTA})", flush=True)

    # the CV on the quantum transform, argkmin_short once per fold
    check(argkmin_route(KNN_K, torch.device(CARD)) == "short",
          f"k={KNN_K} must take argkmin_short")
    before = argkmin.launches
    t0 = time.perf_counter()
    res = cross_validate(KNeighborsClassifier(n_neighbors=KNN_K), Xq, y,
                         cv=StratifiedKFold(10))
    cv_s = time.perf_counter() - t0
    cv_launches = argkmin.launches - before
    check(cv_launches == 10, f"the trial's CV launched argkmin_short "
                             f"{cv_launches} times, not once per fold")
    check(res["test_score"].min() >= KNN_ACCURACY_FLOOR,
          f"trial CV fold accuracy {res['test_score'].min()}")
    print(f"cross_validate(KNeighborsClassifier(n_neighbors={KNN_K}), Xq, "
          f"StratifiedKFold(10)) {N}×{QPCA_COMPONENTS}: {cv_s:.4f} s, "
          f"argkmin_short launches {cv_launches}, test_score "
          f"{res['test_score'].tolist()}, fit_time "
          f"{res['fit_time'].tolist()}, score_time "
          f"{res['score_time'].tolist()}", flush=True)

    # one fold's search at width 61 against its plain version (these
    # launches come after the CV's count was read)
    train, test = next(StratifiedKFold(10).split(np.zeros(N), y))
    Xq_h = Xq.cpu()
    T = Xq_h[train].to(CARD).contiguous()
    Q = Xq_h[test].to(CARD).contiguous()
    tsq = torch.sum(T * T, dim=1)
    idx, d2 = argkmin(T, tsq, Q, KNN_K)
    ref_i, ref_d = argkmin_reference(T, tsq, Q, KNN_K)
    check(bool(((d2 - ref_d).abs() <= D2_RTOL_KNN * ref_d.abs()).all()),
          "argkmin at width 61: d2 off the plain version's")
    ms61 = time_ms(lambda: argkmin(T, tsq, Q, KNN_K))
    plain61 = time_ms(lambda: argkmin_reference(T, tsq, Q, KNN_K))
    bound61, _ = roofline(*argkmin_work(Q.shape[0], T.shape[0], T.shape[1],
                                        KNN_K))
    print(f"argkmin at the trial's fold shape {Q.shape[0]}×{T.shape[0]}×"
          f"{T.shape[1]}, k={KNN_K}: {ms61:.4f} ms (plain {plain61:.4f} ms, "
          f"bound {bound61:.4f} ms); {int((idx != ref_i).sum())} of "
          f"{idx.numel()} indices differ from the plain version, max |d2 − "
          f"plain| {float((d2 - ref_d).abs().max())}", flush=True)

    # true tomography of the same top-k vectors at the full shape
    calls = multinomial_counts.binomial_calls
    t0 = time.perf_counter()
    right, left, *_ = pca.topk_sv_extractors(
        delta=QPCA_DELTA, eps=QPCA_EPS, theta=QPCA_THETA,
        true_tomography=True)
    tomo_s = time.perf_counter() - t0
    calls = multinomial_counts.binomial_calls - calls
    expect = (int(np.ceil(np.log2(M))) + int(np.ceil(np.log2(2 * M)))
              + int(np.ceil(np.log2(N))) + int(np.ceil(np.log2(2 * N))))
    check(calls == expect, f"true tomography made {calls} binomial calls, "
                           f"not {expect}")
    for side, est_v, true_v in (("right", right, pca.components_),
                                ("left", left, pca.left_sv)):
        err = np.linalg.norm(est_v - true_v, axis=1)
        check(np.isfinite(est_v).all() and err.max() <= QPCA_DELTA,
              f"true tomography of the {side} vectors: a row off by "
              f"{err.max()} > δ = {QPCA_DELTA}")
        print(f"true tomography, {side} vectors {est_v.shape}: largest row "
              f"error {err.max()}, median {float(np.median(err))} (δ = "
              f"{QPCA_DELTA})", flush=True)
    print(f"true-tomography top-k extraction: {tomo_s:.4f} s, {calls} "
          f"torch.binomial calls for 2 × {pca.topk} vectors", flush=True)
    return cv_launches, pca


def qpca_card_vs_cpu():
    """QPCA(16) on synthetic_surrogate(4000, 64, 10, seed=784) at
    ε = δ = 0 with every top-k estimator, on the card and on the CPU:
    explained variance, components and the transform equal in norm to
    SMALL_QPCA_RTOL."""
    import numpy as np

    from sq_learn_tpu_torch.datasets import synthetic_surrogate
    from sq_learn_tpu_torch.models import QPCA

    Xs, _ = synthetic_surrogate(4000, 64, 10, seed=784)
    out = {}
    for device in (CARD, "cpu"):
        pca = QPCA(16, random_state=0, device=device).fit(
            Xs, estimate_all=True, eps=0, delta=0, theta_major=QPCA_THETA)
        out[device] = {
            "explained_variance_": pca.explained_variance_,
            "components_": pca.components_,
            "transform": pca.transform(
                Xs, classic_transform=False,
                use_classical_components=False).cpu().numpy()}
    errs = {}
    for name, cpu in out["cpu"].items():
        card = out[CARD][name]
        errs[name] = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu))
        check(errs[name] <= SMALL_QPCA_RTOL,
              f"small qPCA: {name} on the card and the CPU differ by "
              f"{errs[name]} (relative, in norm) > {SMALL_QPCA_RTOL}")
    print(f"small qPCA 4000×64, 16 components, ε = δ = 0: card == CPU, "
          f"relative differences in norm {errs}", flush=True)


def qkmeans_ipe_path(X, y, Xd, torch):
    """Path A: q-means at the reference's defaults (the IPE E-step, the
    sketched σ_min/η statistics), predict/score/transform and both runtime
    models. Returns the fit."""
    import numpy as np

    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.models.qkmeans import MU_GRID
    from sq_learn_tpu_torch.ops.kernels import lloyd_step
    from sq_learn_tpu_torch.sketch import engine

    est = QKMeans(n_clusters=K, n_init=10, max_iter=300, delta=WINDOW,
                  random_state=0)
    lloyd_step.launches = 0
    t0 = time.perf_counter()
    est.fit(X)
    fit_s = time.perf_counter() - t0
    check(lloyd_step.launches == 0,
          f"the IPE fit launched lloyd_step {lloyd_step.launches} times")
    check(np.isfinite(est.cluster_centers_).all()
          and np.isfinite(est.inertia_), "IPE fit is not finite")
    info = est.sketch_info_
    check(info["sketched"] and info["sample_rows"] == SKETCH_ROWS,
          f"IPE fit: sketch_info_ {info}")
    # κ against the float64 decomposition of the same sampled rows' Gram
    idx = engine.sample_indices(
        np.random.default_rng([0, engine.SKETCH_SEED]), N, SKETCH_ROWS)
    idx_t = torch.as_tensor(idx, device=Xd.device)
    comp = engine.fetch_components(engine.sketch_components(Xd, idx_t,
                                                            MU_GRID))
    R64 = Xd[idx_t].double()
    lam64 = float(torch.linalg.eigvalsh((R64.T @ R64) * (N / SKETCH_ROWS))[0])
    kappa64 = engine.finalize_components(
        dict(comp, lam_min=lam64), n=N, m=M, s=SKETCH_ROWS, mu_grid=MU_GRID,
        delta_stat=info["delta_stat"]).condition_number()
    rel = abs(est.condition_number_ - kappa64) / kappa64
    check(rel <= SKETCH_KAPPA_RTOL,
          f"IPE fit: κ {est.condition_number_} against float64 {kappa64}, "
          f"relative error {rel} > {SKETCH_KAPPA_RTOL}")
    fit_ari = ari(y, est.labels_)
    check(fit_ari >= IPE_ARI_FLOOR, f"IPE ARI {fit_ari} < {IPE_ARI_FLOOR}")
    t0 = time.perf_counter()
    pred = est.predict(X, delta=WINDOW)
    predict_s = time.perf_counter() - t0
    pred_ari = ari(est.labels_, pred)
    check(pred.shape == (N,) and pred_ari >= IPE_ARI_FLOOR,
          f"IPE predict: shape {pred.shape}, ARI against labels_ {pred_ari}")
    score, dist = est.score(X), est.transform(X)
    check(np.isfinite(score) and dist.shape == (N, K)
          and np.isfinite(dist).all(), "IPE fit: score/transform output")
    models = {}
    for wc in (False, True):
        q, c = est.quantum_runtime_model(N, M, well_clusterable=wc)
        check(np.isfinite(q) and np.isfinite(c) and q > 0 and c > 0,
              f"runtime model (well_clusterable={wc}): {q}, {c}")
        models[wc] = float(q)
    qs, cs = est.runtime_comparison(N, M)
    check(qs.shape == cs.shape == (100, 100) and np.isfinite(qs).all()
          and np.isfinite(cs).all(),
          f"runtime_comparison surfaces {qs.shape}, {cs.shape}")
    print(f"path A: QKMeans(n_clusters={K}, n_init=10, max_iter=300, "
          f"delta={WINDOW}, random_state=0).fit (IPE E-step, sketch='auto') "
          f"{N}×{M}: {fit_s:.4f} s, n_iter {est.n_iter_}, inertia "
          f"{est.inertia_}, ARI {fit_ari} (floor {IPE_ARI_FLOOR}), "
          f"lloyd_step launches {lloyd_step.launches}; predict(δ={WINDOW}) "
          f"{predict_s:.4f} s, ARI against labels_ {pred_ari}; κ "
          f"{est.condition_number_} against float64 {kappa64} (relative "
          f"{rel}, limit {SKETCH_KAPPA_RTOL}; λ_min float64 {lam64}); eta "
          f"{est.eta_}, mu {est.mu_} ({est.norm_mu_}); sketch_info_ {info}; "
          f"quantum_runtime_model {models[False]} (well-clusterable "
          f"{models[True]}), classical {float(c)}", flush=True)
    return est


def qkmeans_tomography_path(X, y, torch):
    """Path B: δ-means with true tomography of the centers every iteration
    (the Lloyd kernel between the tomography draws). Returns the kernel's
    launches in the fit."""
    import numpy as np

    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.models import qkmeans as tqk
    from sq_learn_tpu_torch.ops.kernels import lloyd_step
    from sq_learn_tpu_torch.ops.quantum.sampling import multinomial_counts
    from sq_learn_tpu_torch.parallel.init import resolve_init_subsample
    from sq_learn_tpu_torch.streaming import streamed_prestats
    from sq_learn_tpu_torch.utils import as_generator

    kw = dict(n_clusters=K, n_init=10, delta=WINDOW,
              true_distance_estimate=False, intermediate_error=True,
              random_state=0)
    est = QKMeans(**kw)
    lloyd_step.launches = 0
    calls = multinomial_counts.binomial_calls
    t0 = time.perf_counter()
    est.fit(X)
    fit_s = time.perf_counter() - t0
    launches = lloyd_step.launches
    calls = multinomial_counts.binomial_calls - calls
    check(launches > 0, "the tomography fit never launched lloyd_step")
    check(np.isfinite(est.cluster_centers_).all()
          and np.isfinite(est.inertia_), "tomography fit is not finite")
    fit_ari = ari(y, est.labels_)
    check(fit_ari >= TOMOGRAPHY_ARI_FLOOR,
          f"tomography fit ARI {fit_ari} < {TOMOGRAPHY_ARI_FLOOR}")
    # every restart: the fit's steps again from the same seed, through the
    # functional core, which returns all restarts (not counted above)
    # (the fit streamed X: its statistics come from the same tile sums)
    check(est.ingest_ == "streamed", f"path B ingest_ {est.ingest_}")
    dev = torch.device(CARD)
    w = torch.ones(N, device=dev)
    gen = as_generator(0, dev)
    sub = resolve_init_subsample(N, K, "auto")
    stats, c0 = tqk.fused_init(gen, None, w, n_init=10, init="k-means++",
                               n_clusters=K, quantum=False,
                               init_subsample=sub,
                               stats=streamed_prestats(X, device=dev))
    tol = 1e-4 * stats["var_mean"]
    _, inertia, centers, n_iter, _ = tqk.lloyd_single(
        gen, stats["Xc"], w, c0, stats["xsq"], delta=WINDOW, mode="delta",
        tol=tol, patience=10, intermediate_error=True)
    check(bool(torch.isfinite(centers).all())
          and bool(torch.isfinite(inertia).all()),
          "tomography: a restart's centers are not finite")
    best = int(torch.argmin(inertia))
    same = np.array_equal((centers[best] + stats["mean"]).cpu().numpy(),
                          est.cluster_centers_)
    check(same, "tomography: the rerun from the same seed does not give the "
                "fit's centers")
    print(f"path B: QKMeans(n_clusters={K}, n_init=10, delta={WINDOW}, "
          f"true_distance_estimate=False, intermediate_error=True, "
          f"random_state=0).fit {N}×{M}: {fit_s:.4f} s, n_iter "
          f"{est.n_iter_}, lloyd_step launches {launches}, torch.binomial "
          f"calls {calls}, ARI {fit_ari} (floor {TOMOGRAPHY_ARI_FLOOR}); all "
          f"{centers.shape[0]} restarts finite (n_iter "
          f"{n_iter.tolist()}), the rerun's best restart equal to the fit's "
          f"centers: {same}", flush=True)
    return launches


def qpca_runtime_path(pca):
    """Path C: the runtime model of the qPCA trial's fitted QPCA, on the
    reference's 100 × 100 mesh."""
    import numpy as np

    nn, mm, q, c = pca.runtime_comparison(N, M)
    surfaces = pca.accumulate_q_runtime(nn, mm)
    check(len(surfaces) >= 1 and all(
        np.shape(sf) == nn.shape and np.isfinite(sf).all() and (sf > 0).all()
        for sf in surfaces), "accumulate_q_runtime: surfaces not finite "
                             "positive of the mesh's shape")
    check(q.shape == c.shape == (100, 100) and np.isfinite(q).all()
          and (q > 0).all(), "runtime_comparison surfaces")
    print(f"path C: QPCA.accumulate_q_runtime on the 100 × 100 mesh to "
          f"({N}, {M}): {len(surfaces)} surface(s), quantum cost at "
          f"({N}, {M}) {float(q[-1, -1])}, classical {float(c[-1, -1])}",
          flush=True)


def qlssvc_split(X, y):
    """Classes 0 and 1 of the surrogate as ±1 (class 0 → +1), training and
    test rows from a permutation seeded with 0."""
    import numpy as np

    rows = np.flatnonzero(y <= 1)
    rows = rows[np.random.default_rng(0).permutation(len(rows))]
    tr = rows[:QLSSVC_TRAIN]
    te = rows[QLSSVC_TRAIN:QLSSVC_TRAIN + QLSSVC_TEST]
    ypm = np.where(y == 0, 1.0, -1.0)
    return X[tr], ypm[tr], X[te], ypm[te]


def qlssvc_path(X, y, torch):
    """Path D: QLSSVC (linear kernel with absolute error, rbf with relative
    error) on the ±1 split: fit, predict and the checks of the solve and
    the noise model."""
    import numpy as np

    from sq_learn_tpu_torch.models import QLSSVC
    from sq_learn_tpu_torch.models.qlssvc import saddle_matrix

    Xtr, ytr, Xte, yte = qlssvc_split(X, y)
    for kernel, error_type in (("linear", "absolute"), ("rbf", "relative")):
        ref = JAX_QLSSVC[kernel]
        t0 = time.perf_counter()
        est = QLSSVC(kernel=kernel, error_type=error_type, random_state=0)
        est.fit(Xtr, ytr)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = est.predict(Xte)
        predict_s = time.perf_counter() - t0
        check(pred.shape == (QLSSVC_TEST,) and set(np.unique(pred)) <= {-1, 1},
              f"QLSSVC {kernel}: predict output")
        acc = float(np.mean(est.classical_predict(Xte) == yte))
        q_acc = float(np.mean(pred == yte))
        check(acc >= ref["accuracy"] - 0.01,
              f"QLSSVC {kernel}: classical_predict accuracy {acc} < JAX's "
              f"{ref['accuracy']} − 0.01")
        # the solve against a float64 decomposition of the same F
        F = saddle_matrix(est.get_kernel(est.X_), est.penalty)
        s64 = torch.linalg.eigvalsh(F.double()).abs().sort(
            descending=True).values.cpu().numpy()
        del F
        sv_err = float(np.max(np.abs(est.singular_values_F_ - s64) / s64))
        cond64 = s64[0] / s64[-1]
        cond_err = abs(est.cond_ - cond64) / cond64
        check(sv_err <= 3 * ref["sv_rel_err"],
              f"QLSSVC {kernel}: singular values of F off float64 by "
              f"{sv_err} > 3 × {ref['sv_rel_err']}")
        check(cond_err <= 3 * ref["cond_rel_err"],
              f"QLSSVC {kernel}: cond_ {est.cond_} against float64 "
              f"{cond64}, relative {cond_err} > 3 × {ref['cond_rel_err']}")
        # the noise model's bound, for both error types: P̃ = P + z with
        # |z| ≤ ε, rounded to float32, so |P̃ − P| ≤ ε + one float32 ulp
        Xq = est._input(Xte)
        h, beta = est._h(Xq), est._betas(Xq)
        P = 0.5 * (1.0 - h / beta)
        worst = {}
        for et in ("absolute", "relative"):
            est.error_type = et
            noisy, eps = est._noisy_P(P, h, beta)
            ulp = torch.finfo(torch.float32).eps * torch.maximum(
                noisy.abs(), P.abs())
            over = float(torch.max(torch.abs(noisy - P) - eps - ulp))
            check(over <= 0, f"QLSSVC {kernel} {et}: |P̃ − P| exceeds ε by "
                             f"{over}")
            worst[et] = float(torch.max(torch.abs(noisy - P)))
        est.error_type = error_type
        print(f"path D: QLSSVC(kernel={kernel!r}, error_type="
              f"{error_type!r}, random_state=0) {QLSSVC_TRAIN}×{M}: fit "
              f"{fit_s:.4f} s, predict {QLSSVC_TEST} rows {predict_s:.4f} "
              f"s; classical accuracy {acc} (JAX {ref['accuracy']}), "
              f"quantum accuracy {q_acc}; cond_ {est.cond_} against float64 "
              f"{cond64} (relative {cond_err}), singular values of F off "
              f"float64 by {sv_err} (relative); largest |P̃ − P| {worst}",
              flush=True)
    # a small fit on the card against the same fit on the CPU
    out = {}
    for device in (CARD, "cpu"):
        fit = QLSSVC(kernel="rbf", random_state=0, device=device).fit(
            Xtr[:500], ytr[:500])
        out[device] = (fit.b_, fit.alpha_, fit.cond_)
    errs = [abs(out[CARD][0] - out["cpu"][0]) / abs(out["cpu"][0]),
            float(np.linalg.norm(out[CARD][1] - out["cpu"][1])
                  / np.linalg.norm(out["cpu"][1])),
            abs(out[CARD][2] - out["cpu"][2]) / out["cpu"][2]]
    check(max(errs) <= SMALL_QLSSVC_RTOL,
          f"small QLSSVC: card and CPU differ by {errs} (b_, alpha_ in "
          f"norm, cond_; relative) > {SMALL_QLSSVC_RTOL}")
    print(f"small QLSSVC 500×{M} (rbf): card == CPU, relative differences "
          f"b_ {errs[0]}, alpha_ {errs[1]} (in norm), cond_ {errs[2]}",
          flush=True)


def cicids_standardized(torch):
    """BASELINE #5's data: the CICIDS surrogate, standardized on the card
    (a tensor there). Returns (X on the card, labels, seconds to scale)."""
    import warnings

    from sq_learn_tpu_torch.datasets import load_cicids
    from sq_learn_tpu_torch.preprocessing import StandardScaler

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the surrogate's notice
        X, y, real = load_cicids(n_samples=SWEEP_N)
    check(not real and X.shape == (SWEEP_N, SWEEP_M),
          f"load_cicids gave {X.shape}, real={real}")
    t0 = time.perf_counter()
    Xs = StandardScaler().fit_transform(X)
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    check(Xs.is_cuda and Xs.shape == (SWEEP_N, SWEEP_M)
          and bool(torch.isfinite(Xs).all())
          and float(Xs.mean(0).abs().max()) < 1e-4,
          "StandardScaler output on the card")
    return Xs, y, scale_s


def lloyd_shape_phase(Xs, k, torch, r=R):
    """The Lloyd kernel at the shape of the rows ``Xs`` on the card, k
    centers, r restarts (R=10 by default), against its plain version on
    the centered rows: window 0, and 0.5 on a fed Gumbel operand. At the
    δ-sweep's shape (50 000 × 78, k=6) rows of 312 bytes take the kernel's
    unaligned staging; at BASELINE #1's (1797 × 64, k=10) the row count is
    not aligned. Returns the shape's entry for the kernel's JSON line."""
    Xc = Xs - Xs.mean(dim=0)
    operands = lloyd_operands(Xc, k, r, torch)
    cases = [("float32", Xc, None, 0.0, True),
             ("float32", Xc, operands["gum"], WINDOW, True)]
    report = hold_lloyd_cases(cases, operands, torch)
    main = report[("float32", WINDOW)]
    return {"shape": f"{Xs.shape[0]}x{Xs.shape[1]} k={k} R={r}",
            "window": WINDOW, "launches": None,
            "max_abs_err": max(main["err"].values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "window_0_ms": report[("float32", 0.0)]["ms"],
            "window_0_plain_ms": report[("float32", 0.0)]["plain_ms"],
            "window_0_bound_ms": report[("float32", 0.0)]["bound_ms"]}


def delta_sweep_path(Xs, y, torch):
    """BASELINE #5, ``examples/delta_tradeoff.py:48-85`` at
    ``--n-samples 50000``: the CICIDS surrogate standardized on the card
    (``Xs``, labels ``y``, from :func:`cicids_standardized`), then
    QKMeans(n_clusters=6, n_init=10, delta=δ, true_distance_estimate=False,
    random_state=0) at each δ, with the
    Lloyd launches of each fit counted from 0. Then a δ=0 fit on the card
    against the same fit on the CPU. Returns the sweep's launches and, per
    δ, the fit's (labels, Lloyd launches, wall seconds)."""
    import warnings

    import numpy as np

    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.ops.kernels import lloyd_step

    total = 0
    sweep = {}
    for delta in SWEEP_DELTAS:
        est = QKMeans(n_clusters=SWEEP_K, n_init=10, delta=delta,
                      true_distance_estimate=False, random_state=0)
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # δ=0's classic notice
            est.fit(Xs)
        wall = time.perf_counter() - t0
        launches = lloyd_step.launches
        total += launches
        sweep[delta] = (est.labels_, launches, wall)
        check(launches > 0, f"δ-sweep δ={delta}: no Lloyd launch")
        check(np.isfinite(est.cluster_centers_).all()
              and np.isfinite(est.inertia_), f"δ-sweep δ={delta}: not finite")
        fit_ari = ari(y, est.labels_)
        if delta == 0:
            check(fit_ari == 1.0, f"δ-sweep δ=0: ARI {fit_ari} ≠ 1.0")
            floor = 1.0
        else:
            floor = JAX_SWEEP_ARI[delta] - SWEEP_MARGIN[delta]
            check(fit_ari >= floor,
                  f"δ-sweep δ={delta}: ARI {fit_ari} < the JAX package's "
                  f"{JAX_SWEEP_ARI[delta]} − {SWEEP_MARGIN[delta]}")
        print(f"δ-sweep δ={delta}: QKMeans fit {wall:.4f} s, n_iter "
              f"{est.n_iter_}, Lloyd launches {launches}, inertia "
              f"{est.inertia_}, ARI {fit_ari} (floor {floor})", flush=True)
    # δ=0 from one init of seeded rows, card against CPU
    Xn = Xs.cpu().numpy()
    init = Xn[np.random.default_rng(1).choice(SWEEP_N, SWEEP_K,
                                              replace=False)]
    fits = {}
    for device in (CARD, "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fits[device] = QKMeans(n_clusters=SWEEP_K, init=init, n_init=1,
                                   delta=0.0, device=device).fit(Xn)
    card, cpu = fits[CARD], fits["cpu"]
    check(np.array_equal(card.labels_, cpu.labels_)
          and card.n_iter_ == cpu.n_iter_,
          f"δ-sweep δ=0: card (n_iter {card.n_iter_}) and CPU (n_iter "
          f"{cpu.n_iter_}) fits differ in "
          f"{int((card.labels_ != cpu.labels_).sum())} labels")
    print(f"δ-sweep δ=0 from one init: card == CPU (labels, n_iter "
          f"{cpu.n_iter_})", flush=True)
    return total, sweep


def tradeoff_legs(Xs, ys, Xm, ym, *, n_train, twin_rows, n_components,
                  errs=TRADEOFF_ERRS, deltas=SWEEP_DELTAS, sketch="auto"):
    """Both legs of the accuracy-vs-quantum-runtime study through the
    port's entry points, recording one ``tradeoff`` per point into the
    caller's obs run (``examples/runtime_tradeoff.py:37-123``).

    Leg 1 on the standardized CICIDS rows ``Xs`` (labels ``ys``):
    QKMeans(n_clusters=6, n_init=10, delta=δ, true_distance_estimate=False,
    random_state=0, sketch=sketch) for each δ — ARI against ``ys``, and
    ``quantum_runtime_model`` at the data's shape for δ > 0 — then one fit
    at the IPE route (δ = TRADEOFF_IPE_DELTA). Leg 2 on ``Xm`` (labels
    ``ym``): one QPCA(n_components) fit; θ, the median singular value of a
    plain fit of the first ``twin_rows`` rows; then per ε+δ the Gaussian
    tomography quantum transform, a k-NN (TRADEOFF_KNN) fitted on its
    first ``n_train`` rows and scored on the rest, and the QADRA
    accountant of the twin fit at ε = δ = (ε+δ)/2, priced at ``Xm``'s
    shape. Tensors stay on their device. Returns, per δ, the fit's
    labels, Lloyd launches, seconds, ARI, q_runtime and κ, the IPE fit's,
    and per ε+δ the accuracy, q_runtime, top-k, the twin's μ(A), argkmin
    launches, seconds, and the transform's realized ‖Xq − X·Vᵀ‖_F
    (``f_norm``) beside its bound √k·(ε+δ) (``bound``); under ``Xq`` the
    last point's representation."""
    import warnings

    import numpy as np

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.models import QPCA, KNeighborsClassifier, QKMeans
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    def qkmeans(delta, ipe):
        est = QKMeans(n_clusters=SWEEP_K, n_init=10, delta=delta,
                      true_distance_estimate=ipe, random_state=0,
                      sketch=sketch)
        lloyd_step.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # δ=0's classic notice
            est.fit(Xs)
        return {"labels": est.labels_, "launches": lloyd_step.launches,
                "wall": time.perf_counter() - t0, "ari": ari(ys, est.labels_),
                "est": est}

    out = {"sweep": {}, "qpca": {}}
    for delta in deltas:
        fit = out["sweep"][delta] = qkmeans(delta, False)
        q_rt = c_rt = None
        if delta > 0:
            quantum, classical = fit["est"].quantum_runtime_model(*Xs.shape)
            q_rt, c_rt = float(np.ravel(quantum)[0]), float(classical)
            fit["kappa"] = fit["est"].condition_number_
        fit["q_runtime"] = q_rt
        obs.frontier.record_tradeoff(
            "cicids_qkmeans_delta", delta, accuracy=fit["ari"],
            accuracy_metric="ari", q_runtime=q_rt, c_runtime=c_rt,
            wall_s=fit["wall"], budget={"delta": delta})
    out["ipe"] = qkmeans(TRADEOFF_IPE_DELTA, True)

    n, m = Xm.shape
    pca = QPCA(n_components, svd_solver="full", random_state=0).fit(Xm)
    twin = Xm[:twin_rows]
    theta = float(np.median(QPCA(n_components, svd_solver="full",
                                 random_state=0).fit(twin).singular_values_))
    for err in errs:
        argkmin.launches = 0
        t0 = time.perf_counter()
        Xq, bound, f_norm = pca.transform(
            Xm, classic_transform=False, epsilon_delta=err,
            quantum_representation=True, norm="est_representation",
            true_tomography=False)["quantum_representation_results"]
        knn = KNeighborsClassifier(n_neighbors=TRADEOFF_KNN).fit(
            Xq[:n_train], ym[:n_train])
        acc = float(np.mean(knn.predict(Xq[n_train:]) == ym[n_train:]))
        q = QPCA(n_components, svd_solver="full", random_state=0).fit(
            twin, estimate_all=True, theta_major=theta, eps=err / 2,
            delta=err / 2, true_tomography=False)
        q_rt = float(np.sum([np.asarray(c, float)
                             for c in q.accumulate_q_runtime(n, m)]))
        wall = time.perf_counter() - t0
        out["qpca"][err] = {"accuracy": acc, "q_runtime": q_rt, "wall": wall,
                            "launches": argkmin.launches, "topk": q.topk,
                            "muA": q.muA, "f_norm": float(f_norm),
                            "bound": float(bound)}
        obs.frontier.record_tradeoff(
            "mnist_qpca_eps_delta", err, accuracy=acc,
            accuracy_metric="holdout_7nn_acc", q_runtime=q_rt,
            c_runtime=float(n) * float(m) ** 2, wall_s=wall,
            budget={"eps": err / 2, "delta": err / 2},
            f_norm_err=float(f_norm))
    out["Xq"] = Xq
    return out


def recorded_sites_and_steps(rec):
    """(guarantee sites, ledger (estimator, step) pairs) of a recorder."""
    return ({g["site"] for g in rec.guarantee_records},
            {(e["estimator"], e["step"]) for e in rec.ledger_entries})


def tradeoff_phase(Xs, ys, sweep, here, torch):
    """The accuracy-vs-quantum-runtime study on the card, under
    ``obs.enable(<artifact>)``: :func:`tradeoff_legs` at the papers'
    sizes, leg 1 held against the obs-off δ-sweep ``sweep`` (labels bit
    for bit, Lloyd launches), leg 2's accuracies against
    TRADEOFF_ACC_FLOOR and the transform's realized error against
    TRADEOFF_FNORM_BAND, then the artifact: schema, audit, sites and
    steps, and the frontier CLI; last the search kernel at leg 2's shape
    (:func:`argkmin_fold_case`). Returns (Lloyd launches, argkmin
    launches, that shape's entry)."""
    import tempfile

    import numpy as np

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.datasets import load_mnist_surrogate_low_margin

    t_phase = time.perf_counter()
    Xm, ym = load_mnist_surrogate_low_margin(TRADEOFF_N)
    Xm = torch.from_numpy(Xm).to(CARD)
    data_s = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tradeoff.jsonl")
        obs.enable(path)
        try:
            out = tradeoff_legs(Xs, ys, Xm, ym, n_train=TRADEOFF_TRAIN,
                                twin_rows=TRADEOFF_TWIN,
                                n_components=TRADEOFF_COMPONENTS)
            audit = obs.guarantees.audit()
            rec = obs.get_recorder()
            rendered = obs.frontier.render(
                obs.frontier.collect(rec.tradeoff_records))
        finally:
            rec = obs.disable()
        lloyd = 0
        for delta, (labels, launches, wall) in sweep.items():
            fit = out["sweep"][delta]
            lloyd += fit["launches"]
            check(np.array_equal(fit["labels"], labels),
                  f"trade-off δ={delta}: the obs-on fit's labels differ from "
                  f"the obs-off fit's in "
                  f"{int((fit['labels'] != labels).sum())} rows")
            check(fit["launches"] == launches,
                  f"trade-off δ={delta}: {fit['launches']} Lloyd launches "
                  f"with obs on, {launches} with obs off")
            print(f"trade-off δ={delta}: ARI {fit['ari']}, q_runtime "
                  f"{fit['q_runtime']}, Lloyd launches {launches} (obs off "
                  f"and on), fit {wall:.4f} s obs off, {fit['wall']:.4f} s "
                  f"obs on", flush=True)
        ipe = out["ipe"]
        check(ipe["launches"] == 0, "the IPE fit launched lloyd_step")
        print(f"trade-off IPE fit δ={TRADEOFF_IPE_DELTA}: ARI {ipe['ari']}, "
              f"{ipe['wall']:.4f} s, n_iter {ipe['est'].n_iter_}",
              flush=True)
        knn = 0
        for err, point in out["qpca"].items():
            knn += point["launches"]
            check(point["launches"] == 1,
                  f"trade-off ε+δ={err}: {point['launches']} argkmin "
                  f"launches, not 1")
            check(np.isfinite(point["q_runtime"]) and point["q_runtime"] > 0,
                  f"trade-off ε+δ={err}: q_runtime {point['q_runtime']}")
            floor = TRADEOFF_ACC_FLOOR[err]
            check(point["accuracy"] >= floor,
                  f"trade-off ε+δ={err}: holdout accuracy "
                  f"{point['accuracy']} < the JAX package's floor {floor}")
            ratio = point["f_norm"] / point["bound"]
            lo, hi = TRADEOFF_FNORM_BAND[err]
            check(lo <= ratio <= hi,
                  f"trade-off ε+δ={err}: ‖Xq − X·Vᵀ‖_F {point['f_norm']} is "
                  f"{ratio} of its bound {point['bound']}, outside the JAX "
                  f"package's band [{lo}, {hi}]")
            print(f"trade-off ε+δ={err}: holdout 7-NN accuracy "
                  f"{point['accuracy']} (floor {floor}), ‖Xq − X·Vᵀ‖_F "
                  f"{point['f_norm']} = {ratio} of its bound "
                  f"{point['bound']} (band [{lo}, {hi}]), q_runtime "
                  f"{point['q_runtime']}, top-k {point['topk']}, "
                  f"{point['wall']:.4f} s", flush=True)
        report = obs.schema.validate_jsonl(path)
        check(not report["errors"],
              f"trade-off artifact: schema errors {report['errors']}")
        flagged = sorted(s for s, a in audit.items() if a["flagged"])
        check(not flagged, f"trade-off artifact: audit flagged {flagged}")
        for site, a in audit.items():
            check(a["fail_prob"] != 0.0 or a["violations"] == 0,
                  f"trade-off artifact: {a['violations']} violations at "
                  f"{site}, whose declared fail_prob is 0")
        sites, steps = recorded_sites_and_steps(rec)
        check(sites == TRADEOFF_SITES,
              f"trade-off guarantee sites {sorted(sites)} ≠ the JAX "
              f"package's {sorted(TRADEOFF_SITES)}")
        check(steps == TRADEOFF_STEPS,
              f"trade-off ledger steps {sorted(steps)} ≠ the JAX "
              f"package's {sorted(TRADEOFF_STEPS)}")
        env = dict(os.environ, PYTHONPATH=here)
        t_cli = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "sq_learn_tpu_torch.obs", "frontier",
             path], cwd=here, env=env, capture_output=True, text=True,
            timeout=120)
        cli_s = time.perf_counter() - t_cli
        check(cli.returncode == 0,
              f"the frontier CLI exited {cli.returncode}: {cli.stderr}")
        # the table, then the per-tenant effective-(ε, δ) section, which
        # no serving tenant fills here
        expected = (rendered.splitlines()
                    + ["== effective (eps, delta) per tenant (live "
                       "draws) ==", obs.frontier.render_effective({})])
        check(cli.stdout.rstrip("\n").splitlines()[1:] == expected,
              f"the frontier CLI printed\n{cli.stdout}\nnot\n{rendered}")
        size = os.path.getsize(path)
    print("trade-off guarantee audit:\n" + obs.guarantees.render(audit),
          flush=True)
    print("trade-off frontier (the CLI printed the same table):\n"
          + rendered, flush=True)
    print(f"trade-off artifact: {report['lines']} records "
          f"({report['by_type']}), {size} bytes, 0 schema errors; sites "
          f"{sorted(sites)}; steps {sorted(steps)}; phase "
          f"{time.perf_counter() - t_phase:.3f} s (the 70 000 × 784 "
          f"surrogate made and uploaded in {data_s:.3f} s, the frontier "
          f"CLI's process {cli_s:.3f} s)", flush=True)
    Xq = out["Xq"]
    T = Xq[:TRADEOFF_TRAIN].contiguous()
    shape = argkmin_fold_case(T, torch.sum(T * T, dim=1),
                              Xq[TRADEOFF_TRAIN:].contiguous(), TRADEOFF_KNN,
                              knn, torch, path="the trade-off holdout")
    return lloyd, knn, shape


def truncated_svd_path(torch):
    """BASELINE #4: TruncatedSVD(n_components=10, algorithm=a, n_iter=5,
    random_state=0).fit_transform on the covertype surrogate for a in
    ('randomized', 'arpack'); the spectrum against a float64 one of the
    same data, computed on the card; the randomized fit again with
    ingest='streamed' at STREAM_TILE_BYTES, against the same spectrum and
    the monolithic fit's components; then a small arpack fit, card
    against CPU. Returns the randomized fit and the surrogate's rows."""
    import numpy as np

    from sq_learn_tpu_torch.datasets import load_covtype
    from sq_learn_tpu_torch.decomposition import TruncatedSVD
    from sq_learn_tpu_torch.streaming import plan_row_tiles

    t0 = time.perf_counter()
    X, _, real = load_covtype()
    check(not real and X.shape == (COVTYPE_N, COVTYPE_M),
          f"load_covtype gave {X.shape}, real={real}")
    print(f"TruncatedSVD: load_covtype() surrogate {COVTYPE_N}×{COVTYPE_M} "
          f"({X.nbytes / 1e6:.0f} MB) made in {time.perf_counter() - t0:.4f} "
          f"s", flush=True)
    X64 = torch.from_numpy(X).to(CARD).double()
    s64 = torch.sqrt(torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:SVD_K])
    s64 = s64.cpu().numpy()
    del X64
    fitted = {}
    for name, algorithm, ingest in (("randomized", "randomized", "auto"),
                                    ("arpack", "arpack", "auto"),
                                    ("streamed", "randomized", "streamed")):
        est = TruncatedSVD(n_components=SVD_K, algorithm=algorithm,
                           n_iter=5, random_state=0, ingest=ingest)
        # the covertype surrogate (125.5 MB) stays under the default cap:
        # the streamed fit runs at STREAM_TILE_BYTES
        env = _env(SQ_STREAM_TILE_BYTES=STREAM_TILE_BYTES
                   if ingest == "streamed" else None)
        try:
            t0 = time.perf_counter()
            Xt = est.fit_transform(X)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            _env(**env)
        fitted[name] = est
        check(est.ingest_ == ("streamed" if ingest == "streamed"
                              else "monolithic"),
              f"TruncatedSVD {name}: ingest_ is {est.ingest_!r}")
        err = float(np.max(np.abs(est.singular_values_ - s64) / s64))
        check(err <= 3 * JAX_SVD_ERR[algorithm],
              f"TruncatedSVD {name}: singular values {err} off float64,"
              f" more than 3 × {JAX_SVD_ERR[algorithm]}")
        comps = est.components_.astype(np.float64)
        orth = float(np.abs(comps @ comps.T - np.eye(SVD_K)).max())
        check(orth <= ORTHONORMAL_ATOL,
              f"TruncatedSVD {name}: components_ off orthonormal by {orth}")
        evr = est.explained_variance_ratio_
        check(bool((evr >= 0).all() and (evr <= 1).all())
              and float(evr.sum()) <= 1.0,
              f"TruncatedSVD {name}: explained_variance_ratio_ {evr}")
        check(Xt.is_cuda and Xt.shape == (COVTYPE_N, SVD_K)
              and bool(torch.isfinite(Xt).all()),
              f"TruncatedSVD {name}: fit_transform output")
        print(f"TruncatedSVD(n_components={SVD_K}, algorithm={algorithm!r}, "
              f"n_iter=5, random_state=0, ingest={ingest!r}) "
              f"{COVTYPE_N}×{COVTYPE_M}: ingest_ {est.ingest_!r}, "
              f"fit_transform {wall:.4f} s; singular values "
              f"{est.singular_values_.tolist()}, largest relative error "
              f"against float64 {err} (limit {3 * JAX_SVD_ERR[algorithm]}); "
              f"components_ orthonormal within {orth}; explained variance "
              f"ratio sum {float(evr.sum())}", flush=True)
    # the streamed fit against the monolithic randomized one: the cosines
    # of the principal angles between their 10-dimensional subspaces
    cos = np.linalg.svd(
        fitted["streamed"].components_.astype(np.float64)
        @ fitted["randomized"].components_.astype(np.float64).T,
        compute_uv=False)
    sv = float(np.max(np.abs(fitted["streamed"].singular_values_
                             / fitted["randomized"].singular_values_ - 1)))
    check(cos.min() >= SUBSPACE_COS_FLOOR,
          f"streamed TruncatedSVD: principal-angle cosine {cos.min()} "
          f"against the monolithic fit < {SUBSPACE_COS_FLOOR}")
    tiles = plan_row_tiles(COVTYPE_N, COVTYPE_M * 4, STREAM_TILE_BYTES)[1]
    print(f"TruncatedSVD ingest='streamed' at {STREAM_TILE_BYTES >> 20} MiB "
          f"tiles ({tiles} tiles a pass) against the monolithic randomized "
          f"fit: singular values within {sv} "
          f"(relative), smallest principal-angle cosine {cos.min()} (floor "
          f"{SUBSPACE_COS_FLOOR})", flush=True)
    small = X[:20_000]
    fits = {device: TruncatedSVD(n_components=SVD_K, algorithm="arpack",
                                 device=device).fit(small)
            for device in (CARD, "cpu")}
    sv = float(np.max(np.abs(fits[CARD].singular_values_
                              / fits["cpu"].singular_values_ - 1)))
    comp = float(np.abs(fits[CARD].components_
                        - fits["cpu"].components_).max())
    check(sv <= 1e-5 and comp <= 1e-4,
          f"small TruncatedSVD: card and CPU differ by {sv} (singular "
          f"values, relative) and {comp} (components)")
    print(f"small TruncatedSVD arpack 20000×{COVTYPE_M}: card == CPU, "
          f"singular values within {sv} (relative), components within "
          f"{comp}", flush=True)
    return fitted["randomized"], X


def grid_pipeline():
    """The error-budget search's pipeline: scale, qPCA, k-NN."""
    from sq_learn_tpu_torch import Pipeline
    from sq_learn_tpu_torch.models import QPCA, KNeighborsClassifier
    from sq_learn_tpu_torch.preprocessing import StandardScaler

    return Pipeline([("scale", StandardScaler()),
                     ("pca", QPCA(svd_solver="full", random_state=0)),
                     ("knn", KNeighborsClassifier())])


def grid_search_path(X, y, torch):
    """The error-budget grid search on the MNIST-shaped surrogate:
    GridSearchCV(Pipeline(StandardScaler, QPCA, KNeighborsClassifier))
    over GRID with StratifiedKFold(5), one argkmin launch per fold's
    predict and none for the refit; then the refit pipeline's predict
    against its steps run one by one, and a small search on the card
    against the CPU. Returns the search's argkmin launches, in all and
    by (width, k)."""
    import numpy as np

    from sq_learn_tpu_torch import config_context
    from sq_learn_tpu_torch.model_selection import (GridSearchCV,
                                                    ParameterGrid,
                                                    StratifiedKFold)
    from sq_learn_tpu_torch.ops.kernels import argkmin

    def search(Xs, ys):
        return GridSearchCV(grid_pipeline(), GRID,
                            cv=StratifiedKFold(GRID_FOLDS)).fit(Xs, ys)

    argkmin.launches = 0
    argkmin.by_shape.clear()
    t0 = time.perf_counter()
    gs = search(X, y)
    wall = time.perf_counter() - t0
    launches = argkmin.launches
    by_shape = dict(argkmin.by_shape)
    n_fits = len(ParameterGrid(GRID)) * GRID_FOLDS
    check(launches == n_fits, f"grid search launched argkmin {launches} "
                              f"times, not once per fold ({n_fits})")
    expected = {(p["pca__n_components"], p["knn__n_neighbors"]): GRID_FOLDS
                for p in ParameterGrid(GRID)}
    check(by_shape == expected,
          f"grid search launched argkmin {by_shape} times by (width, k), "
          f"not {expected}")
    res = gs.cv_results_
    scores = res["split_test_scores"]
    check(scores.min() >= GRID_SCORE_FLOOR,
          f"grid search: a split scored {scores.min()}")
    best = res["params"].index(gs.best_params_)
    check(gs.best_score_ == float(np.mean(scores[best]))
          and gs.best_score_ == float(res["mean_test_score"].max()),
          f"grid search: best_score_ {gs.best_score_} is not its row's mean")
    print(f"GridSearchCV(scale → QPCA → k-NN, {GRID}, StratifiedKFold("
          f"{GRID_FOLDS})) {N}×{M}: {wall:.4f} s, argkmin launches "
          f"{launches} (by (width, k): {by_shape}), best_params_ "
          f"{gs.best_params_}, best_score_ "
          f"{gs.best_score_}, split_test_scores {scores.tolist()}",
          flush=True)
    Xq = X[:10_000]
    steps = gs.best_estimator_.named_steps
    t0 = time.perf_counter()
    pred = gs.best_estimator_.predict(Xq)
    predict_s = time.perf_counter() - t0
    by_step = steps["knn"].predict(steps["pca"].transform(
        steps["scale"].transform(Xq)))
    check(np.array_equal(pred, by_step),
          "grid search: best_estimator_.predict differs from its steps")
    print(f"grid search: best_estimator_.predict of 10000 rows "
          f"{predict_s:.4f} s, equal to the steps run one by one",
          flush=True)
    small = {}
    for device in (CARD, "cpu"):
        with config_context(device=device):
            small[device] = search(X[:3000], y[:3000]).cv_results_
    diff = float(np.abs(small[CARD]["split_test_scores"]
                        - small["cpu"]["split_test_scores"]).max())
    check(small[CARD]["params"] == small["cpu"]["params"]
          and diff <= SMALL_GRID_ATOL,
          f"small grid search: card and CPU cv_results_ differ by {diff}")
    print(f"small grid search 3000×{M}: card == CPU (split scores within "
          f"{diff})", flush=True)
    return launches, by_shape


def argkmin_fold_phase(X, by_shape, torch):
    """The search kernel at the grid search's fold shape: 14 000 queries
    against 56 000 training rows of the standardized surrogate projected
    by QPCA to each width of GRID, at each k of GRID, held against its
    plain version and the exact lists and timed. ``by_shape`` holds the
    grid search's launches by (width, k). Returns the shapes' entries."""
    from sq_learn_tpu_torch.models import QPCA
    from sq_learn_tpu_torch.preprocessing import StandardScaler

    n_train = N * (GRID_FOLDS - 1) // GRID_FOLDS
    Xs = StandardScaler().fit_transform(X)
    entries = []
    for width in GRID["pca__n_components"]:
        pca = QPCA(n_components=width, svd_solver="full",
                   random_state=0).fit(Xs[:n_train])
        T = pca.transform(Xs[:n_train]).contiguous()
        Q = pca.transform(Xs[n_train:]).contiguous()
        tsq = torch.sum(T * T, dim=1)
        for k in GRID["knn__n_neighbors"]:
            entries.append(argkmin_fold_case(T, tsq, Q, k,
                                             by_shape[(width, k)], torch))
    return entries


def argkmin_fold_case(T, tsq, Q, k, launches, torch, path="the grid search"):
    """One search shape of a path (by default one (width, k) of
    :func:`argkmin_fold_phase`): the kernel held against its plain version
    and the exact lists, twice bit-equal, and timed. Returns its entry,
    with the ``launches`` of ``path``."""
    from sq_learn_tpu_torch.ops.kernels import (argkmin, argkmin_reference,
                                                argkmin_work)

    width = T.shape[1]
    idx, d2 = argkmin(T, tsq, Q, k)
    ref_i, ref_d = argkmin_reference(T, tsq, Q, k)
    torch.cuda.synchronize()
    err = float((d2 - ref_d).abs().max())
    # projected rows lie close: d2 cancels ‖q‖² + ‖t‖² against 2·q·t, so
    # its float32 error is held at D2_RTOL of those terms
    tol = D2_RTOL * (torch.sum(Q * Q, dim=1)[:, None] + tsq.max())
    check(bool(((d2 - ref_d).abs() <= tol).all()),
          f"argkmin width {width} k={k}: d2 off the plain version's by "
          f"{err}")
    held = hold_lists(f"width {width} k={k}", idx, d2, ref_i, ref_d, Q, T,
                      torch)
    again = argkmin(T, tsq, Q, k)
    check(bool(torch.equal(again[0], idx) and torch.equal(again[1], d2)),
          f"argkmin width {width} k={k}: two launches differ")
    ms = time_ms(lambda: argkmin(T, tsq, Q, k))
    plain_ms = time_ms(lambda: argkmin_reference(T, tsq, Q, k))
    bound_ms, bound_by = roofline(*argkmin_work(Q.shape[0], T.shape[0],
                                                width, k))
    entry = {"shape": f"{Q.shape[0]}x{T.shape[0]}x{width} k={k}",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by}
    print(f"argkmin at {path}'s shape {entry['shape']}: {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms by "
          f"{entry['bound_by']}), launches in {path} {launches}; {held}",
          flush=True)
    return entry


def minibatch_path(X, y, full_inertia, torch):
    """MiniBatchQKMeans(n_clusters=10, batch_size=1024, delta=δ,
    random_state=0) at 70 000 × 784 for δ in (0, 0.5): fit twice (the
    same bits), predict, then five partial_fit calls on 1024-row
    slices."""
    import warnings

    import numpy as np

    from sq_learn_tpu_torch.models import MiniBatchQKMeans

    for delta in (0.0, 0.5):
        fits, walls = [], []
        for _ in range(2):
            est = MiniBatchQKMeans(n_clusters=K, batch_size=MB_BATCH,
                                   delta=delta, random_state=0)
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # δ=0's classic notice
                est.fit(X)
            walls.append(time.perf_counter() - t0)
            fits.append(est)
        a, b = fits
        check(all(np.array_equal(getattr(a, name), getattr(b, name))
                  for name in ("cluster_centers_", "counts_", "labels_"))
              and (a.n_iter_, a.n_steps_, a.inertia_)
              == (b.n_iter_, b.n_steps_, b.inertia_),
              f"mini-batch δ={delta}: two fits differ")
        check(a.n_steps_ >= a.n_iter_ >= 1,
              f"mini-batch δ={delta}: n_steps_ {a.n_steps_}, n_iter_ "
              f"{a.n_iter_}")
        check(np.isfinite(a.cluster_centers_).all()
              and np.isfinite(a.inertia_), f"mini-batch δ={delta}: finite")
        t0 = time.perf_counter()
        pred = a.predict(X)
        predict_s = time.perf_counter() - t0
        fit_ari = ari(y, pred)
        check(fit_ari >= MB_ARI_FLOOR,
              f"mini-batch δ={delta}: ARI {fit_ari} < {MB_ARI_FLOOR}")
        ratio = a.inertia_ / full_inertia
        check(abs(ratio - 1) <= MB_INERTIA_RTOL,
              f"mini-batch δ={delta}: inertia_ {a.inertia_} is {ratio}× the "
              f"δ=0 QKMeans fit's")
        steps = a.n_steps_
        for i in range(5):
            a.partial_fit(X[i * MB_BATCH:(i + 1) * MB_BATCH])
        check(a.n_steps_ == steps + 5
              and np.isfinite(a.cluster_centers_).all(),
              f"mini-batch δ={delta}: partial_fit bookkeeping")
        print(f"MiniBatchQKMeans(n_clusters={K}, batch_size={MB_BATCH}, "
              f"delta={delta}, random_state=0) {N}×{M}: fit {walls[0]:.4f} s "
              f"then {walls[1]:.4f} s ({steps / walls[1]:.1f} steps/s), "
              f"n_iter_ {a.n_iter_}, n_steps_ {steps}, the same bits twice; "
              f"predict {predict_s:.4f} s, ARI {fit_ari}, inertia_ "
              f"{ratio:.7f}× the δ=0 QKMeans fit's; 5 partial_fit calls",
              flush=True)


def hasher_path(torch):
    """FeatureHasher over 100 000 rows of token dicts (counts of tokens
    from a 5 000-word vocabulary and a categorical field): the tensor lands
    on the card and equals the CPU's."""
    import numpy as np

    from sq_learn_tpu_torch import FeatureHasher

    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 16, HASH_ROWS)
    ends = np.cumsum(lengths)
    words = [f"tok{i}" for i in rng.integers(0, 5000, int(ends[-1]))]
    counts = rng.integers(1, 4, int(ends[-1])).tolist()
    protos = ("tcp", "udp", "icmp")
    rows = []
    for i, (lo, hi) in enumerate(zip(ends - lengths, ends)):
        row = dict(zip(words[lo:hi], counts[lo:hi]))
        row["proto"] = protos[i % 3]
        rows.append(row)
    t0 = time.perf_counter()
    out = FeatureHasher(HASH_FEATURES).transform(rows)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    ref = FeatureHasher(HASH_FEATURES, device="cpu").transform(rows)
    check(out.is_cuda and out.shape == (HASH_ROWS, HASH_FEATURES)
          and out.dtype == torch.float32, "FeatureHasher output")
    check(bool(torch.equal(out.cpu(), ref)),
          "FeatureHasher: the card's tensor differs from the CPU's")
    print(f"FeatureHasher({HASH_FEATURES}) over {HASH_ROWS} dict rows "
          f"({int(ends[-1])} tokens): {card_s:.4f} s onto the card, "
          f"{int((ref != 0).sum())} nonzeros, equal to the CPU's",
          flush=True)


def _env(**values):
    """Set (a value) or unset (None) environment knobs; returns the old
    values for :func:`_env` to restore."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return old


def resident_put_case(X, torch):
    """``streamed_resident_put`` of the 70 000 × 784 surrogate at the
    default cap and at STREAM_TILE_BYTES: each bit-equal to
    ``torch.from_numpy(X).to(card)``; GB/s beside the pageable upload."""
    from sq_learn_tpu_torch.streaming import plan_row_tiles, \
        streamed_resident_put

    def best_s(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return out, statistics.median(walls)

    ref, page_s = best_s(lambda: torch.from_numpy(X).to(CARD))
    rates = {"pageable": X.nbytes / page_s / 1e9}
    for cap in (None, STREAM_TILE_BYTES):
        out, wall = best_s(lambda: streamed_resident_put(X, device=CARD,
                                                         max_bytes=cap))
        check(out.is_cuda and torch.equal(out, ref),
              f"streamed_resident_put at cap {cap} is not bit-equal")
        tiles = plan_row_tiles(N, M * 4, cap)[1]
        rates[f"streamed, {tiles} tiles"] = X.nbytes / wall / 1e9
        del out
    print("resident put of 70000×784 float32 (219.5 MB), bit-equal at both "
          "caps; GB/s (median of 3, host clock to a sync): "
          + ", ".join(f"{k} {v:.3f}" for k, v in rates.items()), flush=True)
    return rates


def streamed_qpca_case(X, Xd, torch):
    """QPCA(61, svd_solver='full', ingest='streamed') at STREAM_TILE_BYTES:
    the spectrum against float64, the components against the monolithic
    fit's; then a resumed Gram pass and a fit with two injected put
    failures, each bit-equal to the uninterrupted one. Returns the Gram
    pass's spectrum error."""
    import tempfile

    import numpy as np

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.models import QPCA
    from sq_learn_tpu_torch.resilience import InjectedInterrupt, faults
    from sq_learn_tpu_torch.streaming import (StreamCheckpoint,
                                              streamed_centered_gram)

    kw = dict(n_components=QPCA_COMPONENTS, svd_solver="full",
              random_state=0)
    t0 = time.perf_counter()
    streamed = QPCA(ingest="streamed", **kw).fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(streamed.ingest_ == "streamed", "qPCA ingest_ is not 'streamed'")
    t0 = time.perf_counter()
    mono = QPCA(**kw).fit(Xd)
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    check(mono.ingest_ == "monolithic", "the qPCA fit of a card tensor")
    X64 = Xd.double() - Xd.double().mean(0)
    ev64 = torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:QPCA_COMPONENTS]
    ev64 = (ev64 / (N - 1)).cpu().numpy()
    del X64
    err = float(np.max(np.abs(streamed.explained_variance_ - ev64) / ev64))
    check(err <= SPECTRUM_RTOL,
          f"streamed qPCA: explained_variance_ {err} off float64 > "
          f"{SPECTRUM_RTOL}")
    cos = np.linalg.svd(streamed.components_.astype(np.float64)
                        @ mono.components_.astype(np.float64).T,
                        compute_uv=False)
    check(cos.min() >= SUBSPACE_COS_FLOOR,
          f"streamed qPCA: principal-angle cosine {cos.min()} against the "
          f"monolithic fit < {SUBSPACE_COS_FLOOR}")
    print(f"QPCA(n_components={QPCA_COMPONENTS}, svd_solver='full', "
          f"ingest='streamed') {N}×{M} at {STREAM_TILE_BYTES >> 20} MiB "
          f"tiles: {fit_s:.4f} s (monolithic on the card tensor "
          f"{mono_s:.4f} s); explained_variance_ {err} off float64 (limit "
          f"{SPECTRUM_RTOL}); components against the monolithic fit's: "
          f"smallest principal-angle cosine {cos.min()} (floor "
          f"{SUBSPACE_COS_FLOOR})", flush=True)
    # resume: an interrupt mid-pass under SQ_STREAM_CKPT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = StreamCheckpoint(os.path.join(tmp, "gram.npz"), every=4)
        _, G_ref, _ = streamed_centered_gram(X, max_bytes=STREAM_TILE_BYTES,
                                             device=CARD)
        faults.arm("abort:tile=7,times=1")
        try:
            streamed_centered_gram(X, max_bytes=STREAM_TILE_BYTES,
                                   device=CARD, checkpoint=ckpt)
            check(False, "the injected interrupt did not fire")
        except InjectedInterrupt:
            pass
        finally:
            faults.disarm()
        rec = obs.enable()
        try:
            _, G_res, _ = streamed_centered_gram(
                X, max_bytes=STREAM_TILE_BYTES, device=CARD,
                checkpoint=ckpt)
        finally:
            obs.disable()
        cursor = rec.gauges.get("resilience.resume_cursor")
        check(cursor == 4 and rec.counters["streaming.tiles"] == 10,
              f"the resumed pass started at tile {cursor} and staged "
              f"{rec.counters.get('streaming.tiles')} tiles")
        check(torch.equal(G_res, G_ref),
              "the resumed Gram differs from the uninterrupted one")
        env = _env(SQ_STREAM_TILE_BYTES=STREAM_TILE_BYTES,
                   SQ_STREAM_CKPT_DIR=tmp)
        try:
            plain = QPCA(ingest="streamed", **kw).fit(X)
            faults.arm("abort:tile=9,times=1")
            try:
                QPCA(ingest="streamed", **kw).fit(X)
                check(False, "the injected interrupt did not fire")
            except InjectedInterrupt:
                pass
            finally:
                faults.disarm()
            resumed = QPCA(ingest="streamed", **kw).fit(X)
        finally:
            _env(**env)
    same = all(np.array_equal(getattr(resumed, a), getattr(plain, a))
               for a in ("mean_", "all_singular_values_", "components_",
                         "left_sv"))
    check(same, "the resumed qPCA fit differs from the uninterrupted one")
    # two transient put failures: retried, the result bit-equal
    faults.arm("put_fail:tiles=3/7,times=1")
    rec = obs.enable()
    env = _env(SQ_STREAM_TILE_BYTES=STREAM_TILE_BYTES)
    try:
        retried = QPCA(ingest="streamed", **kw).fit(X)
    finally:
        _env(**env)
        obs.disable()
        plan = faults.disarm()
    retries = rec.counters.get("resilience.retries")
    check(retries == 2 and len(plan.events) == 2,
          f"put_fail:tiles=3/7: {retries} retries, {len(plan.events)} "
          f"faults")
    check(all(np.array_equal(getattr(retried, a), getattr(plain, a))
              for a in ("mean_", "all_singular_values_", "components_")),
          "the fit with retried tiles differs from the plain one")
    print(f"resume: interrupted at tile 7 of 14, resumed at tile {cursor}, "
          f"Gram bit-equal; an interrupted qPCA fit resumed to the plain "
          f"fit's bits; put_fail:tiles=3/7,times=1: {retries} retries, the "
          f"fit bit-equal", flush=True)
    return err


def breaker_case(X, torch):
    """SQ_BREAKER_K consecutive put failures trip the breaker: the fit
    raises BreakerOpenError, sets no fitted attribute, and so does the
    next streamed fit's preflight; reset afterwards."""
    from sq_learn_tpu_torch.models import QPCA
    from sq_learn_tpu_torch.resilience import (BreakerOpenError, breaker,
                                               faults)

    est = QPCA(n_components=QPCA_COMPONENTS, svd_solver="full",
               ingest="streamed", random_state=0)
    env = _env(SQ_STREAM_TILE_BYTES=STREAM_TILE_BYTES, SQ_BREAKER_K=3,
               SQ_RETRY_BACKOFF_S=0.001)
    raised = []
    try:
        faults.arm("put_fail:tiles=2,times=10")
        for attempt in range(2):
            try:
                est.fit(X)
            except BreakerOpenError as exc:
                raised.append(str(exc))
            faults.disarm()
    finally:
        faults.disarm()
        state = breaker.state()
        breaker.reset("chip_smoke")
        _env(**env)
    check(len(raised) == 2 and state == "open"
          and not hasattr(est, "components_"),
          f"breaker: {len(raised)} raises, state {state}")
    check("qpca.fit" in raised[1], "the second fit's preflight did not "
                                   "raise")
    print(f"breaker: 3 consecutive put failures opened it; the fit raised "
          f"BreakerOpenError ({raised[0][:90]}…), the next fit's preflight "
          f"raised too, no fitted state; reset to {breaker.state()}",
          flush=True)


def streamed_knn_case(X, y, Xd, torch):
    """The streamed 7-NN search: 10 000 queries against 60 000 × 784 at a
    KNN_TILE_BYTES cap, bit-equal to the monolithic search; the kernel
    held and timed at the full tile's shape. Returns (launches in the
    streamed search, the tile shape's entry)."""
    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.models import KNeighborsClassifier
    from sq_learn_tpu_torch.ops.kernels import argkmin
    from sq_learn_tpu_torch.streaming import plan_row_tiles

    knn = KNeighborsClassifier(n_neighbors=KNN_K).fit(Xd[:N_TRAIN],
                                                      y[:N_TRAIN])
    Xq = X[N_TRAIN:]
    d_ref, i_ref = knn.kneighbors(Xd[N_TRAIN:])
    env = _env(SQ_STREAM_TILE_BYTES=KNN_TILE_BYTES)
    argkmin.launches = 0
    before = argkmin.by_shape[(M, KNN_K)]
    rec = obs.enable()
    try:
        t0 = time.perf_counter()
        d_s, i_s = knn.kneighbors(Xq)
        wall = time.perf_counter() - t0
    finally:
        obs.disable()
        _env(**env)
    launches = argkmin.by_shape[(M, KNN_K)] - before
    rows, tiles = plan_row_tiles(len(Xq), M * 4, KNN_TILE_BYTES)
    check(launches == tiles == argkmin.launches == 8
          and rec.counters["streaming.tiles"] == tiles,
          f"streamed 7-NN: {launches} launches at (784, 7) for {tiles} "
          f"tiles")
    import numpy as np

    check(np.array_equal(i_s, i_ref) and np.array_equal(d_s, d_ref),
          "the streamed 7-NN search differs from the monolithic one")
    span = [s for s in rec.spans if s["name"] == "knn.search"][0]
    check(span["attrs"]["engine"] == "streamed-device",
          f"streamed 7-NN engine {span['attrs']['engine']}")
    print(f"streamed 7-NN: 10000 queries × 60000×784 at "
          f"{KNN_TILE_BYTES >> 20} MiB, {tiles} tiles of {rows} rows: "
          f"{wall:.4f} s, argkmin launches {launches}, indices and "
          f"distances bit-equal to the monolithic search", flush=True)
    T = knn.X_fit_
    Q = torch.from_numpy(Xq[:rows]).to(CARD)
    return launches, argkmin_fold_case(T, knn._x_sq_fit, Q, KNN_K, launches,
                                       torch, path="the streamed 7-NN "
                                                   "search")


def checkpoint_case(est, pca, X, y, Xd, Xsweep, ysweep, torch):
    """Save and load the fitted QKMeans and QPCA and a fitted
    KNeighborsClassifier on the card (outputs equal), then
    examples/streaming_fit.py's flow on the CICIDS surrogate."""
    import tempfile
    import warnings

    import numpy as np

    from sq_learn_tpu_torch.models import (KNeighborsClassifier,
                                           MiniBatchQKMeans)
    from sq_learn_tpu_torch.utils import load_estimator, save_estimator

    knn = KNeighborsClassifier(n_neighbors=KNN_K).fit(Xd[:N_TRAIN],
                                                      y[:N_TRAIN])
    Xq = Xd[N_TRAIN:]
    with tempfile.TemporaryDirectory() as tmp:
        outputs = {
            "qkmeans": (est, lambda e: (e.predict(Xq), e.transform(Xq))),
            "qpca": (pca, lambda e: (e.transform(Xq).cpu().numpy(),)),
            "knn": (knn, lambda e: (e.predict(Xq), *e.kneighbors(Xq)))}
        for name, (fitted, run) in outputs.items():
            path = save_estimator(fitted, os.path.join(tmp, name))
            back = load_estimator(path)
            check(all(np.array_equal(a, b)
                      for a, b in zip(run(back), run(fitted))),
                  f"checkpoint: the loaded {name} predicts otherwise")
        Xb = Xsweep.cpu().numpy()
        batches = [Xb[i:i + MB_BATCH] for i in range(0, len(Xb), MB_BATCH)]
        mb = MiniBatchQKMeans(n_clusters=STREAM_FIT_CLUSTERS, delta=0.3,
                              true_distance_estimate=False, random_state=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for batch in batches[:STREAM_FIT_SAVE_AFTER]:
                mb.partial_fit(batch)
            save_estimator(mb, os.path.join(tmp, "mb"))
            resumed = load_estimator(os.path.join(tmp, "mb"))
            for batch in batches[STREAM_FIT_SAVE_AFTER:]:
                resumed.partial_fit(batch)
    fit_ari = ari(ysweep, resumed.predict(Xb))
    check(resumed.n_steps_ == len(batches),
          f"streaming_fit flow: n_steps_ {resumed.n_steps_}, "
          f"{len(batches)} batches")
    check(fit_ari >= STREAM_FIT_ARI_FLOOR,
          f"streaming_fit flow: ARI {fit_ari} < {STREAM_FIT_ARI_FLOOR}")
    print(f"checkpoints: QKMeans, QPCA(61) and 7-NN saved and loaded on the "
          f"card, outputs equal; examples/streaming_fit.py's flow on the "
          f"CICIDS surrogate: {len(batches)} partial_fit batches of "
          f"{MB_BATCH}, saved after {STREAM_FIT_SAVE_AFTER}, loaded, "
          f"n_steps_ {resumed.n_steps_}, ARI {fit_ari} (floor "
          f"{STREAM_FIT_ARI_FLOOR})", flush=True)


def item7_case(X, y, Xd, classic, torch):
    """The estimators' last parameters at 70 000 × 784: q-means in float16
    (the JAX package's XLA route: no Lloyd launch), algorithm='elkan' at
    δ=0 (warns, the lloyd fit's labels), float64 k-NN (no argkmin launch)
    and qPCA's bfloat16 partial-U route. Returns the Lloyd launches."""
    import warnings

    import numpy as np

    from sq_learn_tpu_torch import config_context
    from sq_learn_tpu_torch.models import (QPCA, KNeighborsClassifier,
                                           QKMeans)
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    kw = dict(n_clusters=K, n_init=10, max_iter=300, delta=0.0,
              random_state=0)
    lloyd_step.launches = argkmin.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        f16 = QKMeans(compute_dtype="float16", **kw).fit(X)
        f16_s = time.perf_counter() - t0
    f16_ari = ari(y, f16.labels_)
    check(lloyd_step.launches == 0 and f16_ari >= ARI_FLOOR,
          f"float16 q-means: {lloyd_step.launches} Lloyd launches, ARI "
          f"{f16_ari}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        elkan = QKMeans(algorithm="elkan", **kw).fit(X)
        elkan_s = time.perf_counter() - t0
    elkan_launches = lloyd_step.launches
    check(any("elkan" in str(w.message) for w in caught)
          and elkan_launches > 0
          and np.array_equal(elkan.labels_, classic.labels_),
          "algorithm='elkan': no warning, no Lloyd launch or other labels "
          "than the lloyd fit's")
    with config_context(default_dtype="float64"):
        t0 = time.perf_counter()
        knn = KNeighborsClassifier(n_neighbors=KNN_K).fit(X[:N_TRAIN],
                                                          y[:N_TRAIN])
        acc = knn.score(X[N_TRAIN:], y[N_TRAIN:])
        knn_s = time.perf_counter() - t0
    check(knn.X_fit_.dtype == torch.float64 and argkmin.launches == 0
          and acc >= KNN_ACCURACY_FLOOR,
          f"float64 7-NN: {argkmin.launches} argkmin launches, accuracy "
          f"{acc}")
    bf = QPCA(n_components=QPCA_COMPONENTS, svd_solver="full",
              ingest="monolithic", compute_dtype="bfloat16").fit(X)
    X64 = Xd.double() - Xd.double().mean(0)
    ev64 = torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:QPCA_COMPONENTS]
    ev64 = (ev64 / (N - 1)).cpu().numpy()
    del X64
    bf_err = float(np.max(np.abs(bf.explained_variance_ - ev64) / ev64))
    check(bf.effective_compute_dtype_ == "bfloat16"
          and bf_err <= BF16_SPECTRUM_RTOL,
          f"bfloat16 qPCA: effective {bf.effective_compute_dtype_}, "
          f"explained_variance_ {bf_err} off float64 > {BF16_SPECTRUM_RTOL}")
    print(f"item 7: float16 q-means {f16_s:.4f} s, n_iter {f16.n_iter_}, "
          f"ARI {f16_ari}, Lloyd launches 0; elkan {elkan_s:.4f} s warned, "
          f"{elkan_launches} Lloyd launches, labels equal to the lloyd "
          f"fit's; float64 7-NN fit + score {knn_s:.4f} s, accuracy {acc}, "
          f"argkmin launches 0; bfloat16 qPCA(61) explained_variance_ "
          f"{bf_err} off float64 (limit {BF16_SPECTRUM_RTOL})", flush=True)
    return elkan_launches


# -- the out-of-core phase ---------------------------------------------------
# S1: create_synthetic_store(1 000 000 × 784, 10 classes, seed 784), 8 MiB
# shards (2 674 rows, 374 shards), 3.14 GB; its fits run under a 256 MiB
# single-materialization budget. The mini-batch fit runs 2 epochs of
# 1024-row batches (977 a pass) and labels the store with one Lloyd launch
# per 1024-row tile.
OOC_N, OOC_M, OOC_K, OOC_SEED = 1_000_000, 784, 10, 784
OOC_BUDGET = 256 << 20
OOC_BATCH, OOC_EPOCHS, OOC_ARI_FLOOR = 1024, 2, 0.95
OOC_TILES = -(-OOC_N // OOC_BATCH)
OOC_SAMPLED_TILES = (0, OOC_TILES // 2, OOC_TILES - 1)  # the last is a tail
OOC_COMPONENTS = 61
# the store qPCA's singular values against a float64 Gram of the store: 3×
# the JAX package's float32 error on its store route at 400 000 × 784, the
# largest of the CPU sizes ``PYTHONPATH=. JAX_PLATFORMS=cpu python
# tests/test_torch_oocore.py`` measures (2.19e-5 at 100 000, 4.00e-5 at
# 200 000 rows)
OOC_SPECTRUM_RTOL = 3 * 4.571089676113689e-05
# S2: store_from_array of synthetic_surrogate(100 000, 784, 10, seed=784),
# 313.6 MB in 38 shards; S3: 1 000 × 784 quantized pixel rows in 1 MiB
# shards, LZ4 (the pure-Python codec runs at ~2 MB/s)
OOC_S2_N, OOC_S3_N, OOC_S3_SHARD_BYTES = 100_000, 1_000, 1 << 20
OOC_CODEC_RATIO = 0.7
OOC_CKPT_EVERY = 25
# the JAX package's out-of-core span and counter names (its oocore/ and
# models/minibatch.py; tests/test_torch_oocore.py pins the sets)
OOC_SPANS = frozenset({
    "oocore.create_store", "oocore.minibatch_fit", "oocore.epoch",
    "oocore.assign_labels", "oocore.prefetch", "minibatch.fit_store",
    "minibatch.partial_fit_store"})
OOC_COUNTERS = frozenset({
    "oocore.shard_reads", "oocore.shard_read_bytes", "oocore.crc_failures",
    "oocore.rereads", "oocore.prefetch_hits", "oocore.prefetch_stalls",
    "oocore.prefetch_stall_s", "oocore.prefetch_occupancy",
    "oocore.codec_bytes_in", "oocore.codec_bytes_out",
    "oocore.async_ckpt_writes", "oocore.async_ckpt_dropped"})
# the killed child: a δ-means store fit of S2, its checkpoints every 25
# batches, slowed by read stalls so that the parent sees a snapshot of
# epoch 1 before the fit ends
OOC_CHILD = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import sq_learn_tpu_torch as sqt
from sq_learn_tpu_torch import obs, oocore
from sq_learn_tpu_torch.models import MiniBatchQKMeans
sqt.set_config(device=sys.argv[5])
rec = obs.enable()
est = MiniBatchQKMeans(**eval(sys.argv[4])).fit(oocore.open_store(sys.argv[2]))
np.savez(sys.argv[3], centers=est.cluster_centers_, counts=est.counts_,
         n_steps=est.n_steps_, labels=est.labels_,
         resumed_from=rec.gauges.get("resilience.resume_cursor", 0))
"""


def ooc_shards(n):
    """Shards of an n × 784 float32 store at the default 8 MiB (374 for S1,
    38 for S2)."""
    return -(-n // ((8 << 20) // (OOC_M * 4)))


def ooc_truth(store):
    """The truth labels of a synthetic store: shard i's first draw."""
    import numpy as np

    seed = store.manifest["provenance"]["seed"]
    n_classes = store.manifest["provenance"]["n_classes"]
    return np.concatenate([
        np.random.default_rng((seed, i)).integers(0, n_classes, size=rows)
        for i, rows in enumerate(store.shard_sizes)])


def ooc_label_kernel(store, centers, torch):
    """The Lloyd kernel at the labelling pass's shape (1024 × 784, k=10,
    R=1, window 0) on three of its tiles (the first, a middle one and the
    padded tail), against its plain version and the float64 distances:
    labels agree wherever no center lies within three times the kernel's
    worst min_d2 error of the deciding boundary, min_d2 within D2_RTOL,
    inertia within rtol 1e-5; then timed on the first tile against the
    plain version and the bound. Returns the kernel's shape entry. Its
    own launches, made to compare the kernel, leave the count as it was."""
    import numpy as np

    from sq_learn_tpu_torch.ops.kernels import (lloyd_step,
                                                lloyd_step_reference,
                                                lloyd_step_work)

    counted = lloyd_step.launches
    n, m = store.shape
    C = torch.from_numpy(np.ascontiguousarray(centers)).to(CARD)[None]
    csq = torch.sum(C * C, dim=-1)
    C64 = C.double()
    worst = {"min_d2": 0.0, "inertia_rel": 0.0, "flips": 0}
    first = None
    for t in OOC_SAMPLED_TILES:
        start, stop = t * OOC_BATCH, min(n, (t + 1) * OOC_BATCH)
        valid = stop - start
        X = torch.zeros((OOC_BATCH, m), device=CARD)
        X[:valid] = torch.from_numpy(store.read_rows(start, stop)).to(CARD)
        w = (torch.arange(OOC_BATCH, device=CARD) < valid).float()
        xsq = torch.sum(X * X, dim=1)
        out = lloyd_step(X, w, xsq, C)
        ref = lloyd_step_reference(X, w, xsq, C)
        d2 = ((xsq.double()[None, :, None] + (C64 ** 2).sum(-1)[:, None, :])
              - 2.0 * torch.matmul(X.double(), C64.transpose(1, 2)))
        d2, lab_k, lab_r = d2[:, :valid], out[0][:, :valid], ref[0][:, :valid]
        exact_min = d2.min(dim=-1).values
        tol = D2_RTOL * (xsq[None, :valid] + csq.max(dim=1).values[:, None])
        err = float((out[1][:, :valid] - ref[1][:, :valid]).abs().max())
        check(bool(((out[1][:, :valid] - ref[1][:, :valid]).abs()
                    <= tol).all()),
              f"labelling tile {t}: min_d2 off its plain version by {err}")
        k_err = float((out[1][:, :valid] - exact_min).abs().max())
        margin = 3.0 * max(k_err, float((ref[1][:, :valid]
                                          - exact_min).abs().max()))
        for other, what in ((d2.argmin(-1), "the float64 decision"),
                            (lab_r, "the plain version")):
            bad = unexplained_flips(d2, lab_k, other.to(lab_k.dtype), 0.0,
                                    margin)
            check(bad == 0, f"labelling tile {t}: {bad} label flips "
                            f"against {what} beyond the margin {margin}")
        rel = float((out[4] - ref[4]).abs().max() / ref[4].abs().max())
        check(rel <= 1e-5, f"labelling tile {t}: inertia {float(out[4][0])} "
                           f"against {float(ref[4][0])}, relative {rel}")
        worst = {"min_d2": max(worst["min_d2"], err),
                 "inertia_rel": max(worst["inertia_rel"], rel),
                 "flips": worst["flips"] + int((lab_k != lab_r).sum())}
        if first is None:
            first = (X, w, xsq)
    X, w, xsq = first
    ms = time_ms(lambda: lloyd_step(X, w, xsq, C))
    plain_ms = time_ms(lambda: lloyd_step_reference(X, w, xsq, C))
    lloyd_step.launches = counted
    bound_ms, bound_by = roofline(*lloyd_step_work(
        OOC_BATCH, m, OOC_K, 1, torch.float32, 0.0))
    entry = {"shape": f"{OOC_BATCH}x{m} k={OOC_K} R=1", "window": 0.0,
             "launches": None, "max_abs_err": worst["min_d2"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by}
    print(f"lloyd_step at the labelling shape {entry['shape']}, tiles "
          f"{OOC_SAMPLED_TILES}: label flips against the plain version "
          f"{worst['flips']} (none beyond the float32 margin), max |min_d2 "
          f"err| {worst['min_d2']}, inertia relative {worst['inertia_rel']}; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{entry['bound_ms']:.5f} ms by {entry['bound_by']})", flush=True)
    return entry


def ooc_float64_spectrum(store, k, torch):
    """The top-k singular values of the centered store from a float64
    Gram accumulated on the card in one streamed pass."""
    from sq_learn_tpu_torch.streaming import stream_fold

    n, m = store.shape

    def step(acc, tile):
        t = tile.double()
        acc[0].addmm_(t.T, t)
        acc[1].add_(t.sum(0))
        return acc

    G, colsum = stream_fold(
        store, step, (torch.zeros((m, m), dtype=torch.float64),
                      torch.zeros(m, dtype=torch.float64)),
        device=CARD, checkpoint=False)
    mean = colsum / n
    ev = torch.linalg.eigvalsh(G - n * torch.outer(mean, mean)).flip(0)[:k]
    return torch.sqrt(ev).cpu().numpy()


def ooc_s1_case(tmp, torch):
    """S1: the store build, the mini-batch fit and its labelling pass
    (ARI, 977 Lloyd launches, the kernel held on sampled tiles), a refit
    with the same bits, the store qPCA against a float64 spectrum, a host
    walk of the store. Returns the Lloyd kernel's shape entry, its
    launches those of the two fits' labelling passes."""
    import numpy as np

    from sq_learn_tpu_torch import oocore
    from sq_learn_tpu_torch.models import QPCA, MiniBatchQKMeans
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    t0 = time.perf_counter()
    old = _env(SQ_OOC_PREFETCH_THREADS=6)
    try:
        S1 = oocore.create_synthetic_store(
            os.path.join(tmp, "s1"), OOC_N, OOC_M, n_classes=OOC_K,
            seed=OOC_SEED, kind="gaussian")
    finally:
        _env(**old)
    build_s = time.perf_counter() - t0
    check(S1.shape == (OOC_N, OOC_M) and S1.n_shards == ooc_shards(OOC_N),
          f"S1 has shape {S1.shape} in {S1.n_shards} shards")
    truth = ooc_truth(S1)
    print(f"S1 {OOC_N}×{OOC_M} float32, {S1.nbytes / 1e9:.3f} GB in "
          f"{S1.n_shards} shards of {S1.shard_sizes[0]} rows: built in "
          f"{build_s:.3f} s ({S1.nbytes / build_s / 1e9:.3f} GB/s); disk "
          f"free after it {shutil_free(tmp) / 1e9:.1f} GB", flush=True)
    kw = dict(n_clusters=OOC_K, batch_size=OOC_BATCH, max_iter=OOC_EPOCHS,
              max_no_improvement=None, delta=WINDOW, random_state=0)
    old = _env(SQ_OOC_RAM_BUDGET_BYTES=OOC_BUDGET)
    try:
        fits, walls = [], []
        for run in range(2):
            before = lloyd_step.launches
            t0 = time.perf_counter()
            est = MiniBatchQKMeans(**kw).fit(S1)
            walls.append(time.perf_counter() - t0)
            launches = lloyd_step.launches - before
            check(launches == OOC_TILES and argkmin.launches == 0,
                  f"the S1 fit launched lloyd_step {launches} and argkmin "
                  f"{argkmin.launches} times, not {OOC_TILES} and 0")
            fits.append(est)
        a, b = fits
        check(a.n_steps_ == OOC_EPOCHS * OOC_TILES and a.n_iter_ == 2,
              f"S1 fit: n_steps_ {a.n_steps_}, n_iter_ {a.n_iter_}")
        check(all(np.array_equal(getattr(a, name), getattr(b, name))
                  for name in ("cluster_centers_", "counts_", "labels_"))
              and a.inertia_ == b.inertia_, "S1: two fits differ")
        check(np.isfinite(a.cluster_centers_).all()
              and np.isfinite(a.inertia_), "S1 fit is not finite")
        fit_ari = ari(truth, a.labels_)
        check(fit_ari >= OOC_ARI_FLOOR,
              f"S1 fit: ARI {fit_ari} < {OOC_ARI_FLOOR}")
        print(f"MiniBatchQKMeans({kw}).fit(S1) under a {OOC_BUDGET}-byte "
              f"budget: {walls[0]:.3f} s, then {walls[1]:.3f} s with the "
              f"same bits; n_steps_ {a.n_steps_}, ARI {fit_ari}, inertia_ "
              f"{a.inertia_}, {launches} Lloyd launches in the labelling "
              f"pass", flush=True)
        t0 = time.perf_counter()
        labels, inertia = oocore.assign_labels(S1, a.cluster_centers_,
                                               batch_rows=OOC_BATCH)
        label_s = time.perf_counter() - t0
        check(np.array_equal(labels, a.labels_) and inertia == a.inertia_,
              "S1: a second labelling pass differs")
        entry = ooc_label_kernel(S1, a.cluster_centers_, torch)
        entry["launches"] = 2 * OOC_TILES
        print(f"S1 labelling pass alone: {label_s:.3f} s, "
              f"{S1.nbytes / label_s / 1e9:.3f} GB/s", flush=True)
        t0 = time.perf_counter()
        pca = QPCA(n_components=OOC_COMPONENTS, svd_solver="full").fit(S1)
        pca_s = time.perf_counter() - t0
    finally:
        _env(**old)
    check(pca.ingest_ == "streamed", f"S1 qPCA ingest_ {pca.ingest_}")
    S64 = ooc_float64_spectrum(S1, OOC_COMPONENTS, torch)
    rel = np.abs(pca.singular_values_.astype(np.float64) - S64) / S64
    check(rel.max() <= OOC_SPECTRUM_RTOL,
          f"S1 qPCA: singular values off float64 by {rel.max()} > "
          f"{OOC_SPECTRUM_RTOL}")
    view = S1.prefetched()
    rows, _ = oocore.store._plan_shards(OOC_N, OOC_M * 4, 128 << 20)
    t0 = time.perf_counter()
    try:
        for start in range(0, OOC_N, rows):
            view.read_rows(start, min(OOC_N, start + rows))
    finally:
        view.close()
    walk_s = time.perf_counter() - t0
    print(f"QPCA({OOC_COMPONENTS}, svd_solver='full').fit(S1): {pca_s:.3f} s, "
          f"ingest_ streamed, singular values within {rel.max()} of the "
          f"float64 Gram (limit {OOC_SPECTRUM_RTOL}); host walk of S1 "
          f"(read, CRC, 128 MiB tiles, readahead): {walk_s:.3f} s = "
          f"{S1.nbytes / walk_s / 1e9:.3f} GB/s", flush=True)
    return entry


def shutil_free(path):
    import shutil

    return shutil.disk_usage(path).free


def ooc_s2_case(tmp, torch):
    """S2: the store qPCA against the streamed fit of its array; prefetch
    depth 0 against 3; each read injector at depth 3 against the clean
    fit; persistent corruption and a breaker trip raise."""
    import numpy as np

    from sq_learn_tpu_torch import oocore
    from sq_learn_tpu_torch.datasets import synthetic_surrogate
    from sq_learn_tpu_torch.models import QPCA, MiniBatchQKMeans
    from sq_learn_tpu_torch.resilience import faults, supervisor

    X2, _ = synthetic_surrogate(OOC_S2_N, OOC_M, OOC_K, seed=OOC_SEED)
    S2 = oocore.store_from_array(os.path.join(tmp, "s2"), X2)
    check(S2.n_shards == ooc_shards(OOC_S2_N),
          f"S2 has {S2.n_shards} shards")
    kw = dict(n_components=OOC_COMPONENTS, svd_solver="full")
    disk = QPCA(**kw).fit(S2)
    ram = QPCA(ingest="streamed", **kw).fit(X2)
    check(disk.ingest_ == ram.ingest_ == "streamed"
          and np.array_equal(disk.singular_values_, ram.singular_values_)
          and np.array_equal(disk.components_, ram.components_),
          "S2: the store qPCA fit differs from the streamed array fit")
    fit_kw = dict(n_clusters=OOC_K, batch_size=OOC_BATCH, max_iter=2,
                  max_no_improvement=None, delta=WINDOW, random_state=0)

    def fit(depth, spec=None):
        old = _env(SQ_OOC_PREFETCH_DEPTH=depth, SQ_RETRY_BACKOFF_S=0.001)
        plan = faults.arm(spec) if spec else None
        try:
            est = MiniBatchQKMeans(**fit_kw).fit(oocore.open_store(S2.path))
        finally:
            faults.disarm()
            _env(**old)
        if plan is not None:
            check(spec.split(":")[0] in {e["kind"] for e in plan.events},
                  f"S2: {spec} injected nothing")
        return est

    def same(a, b):
        return all(np.array_equal(getattr(a, name), getattr(b, name))
                   for name in ("cluster_centers_", "counts_", "labels_"))

    t0 = time.perf_counter()
    ref = fit(0)
    ref_s = time.perf_counter() - t0
    check(same(ref, fit(3)), "S2: prefetch depth 3 differs from depth 0")
    for spec in ("read_fail:tiles=3/17,times=1",
                 "read_stall:tiles=5,times=1,s=0.05",
                 "corrupt_shard:tiles=7/30,times=1",
                 "cold_tier:s=0.002,per_mb=0.01"):
        check(same(ref, fit(3, spec)),
              f"S2: the fit under {spec} differs from the clean fit")
    try:
        fit(3, "corrupt_shard:tiles=11,times=99")
        check(False, "S2: persistent corruption did not raise")
    except oocore.ShardCorruptionError as exc:
        check("shard 11" in str(exc), f"S2: corruption raised {exc}")
    try:
        fit(3, "read_fail:p=1,times=99")
        check(False, "S2: a breaker trip did not raise")
    except supervisor.BreakerOpenError as exc:
        check("oocore.read_shard" in str(exc), f"S2: breaker raised {exc}")
    finally:
        supervisor.breaker.reset("chip_smoke")
    print(f"S2 {OOC_S2_N}×{OOC_M} ({S2.nbytes / 1e6:.1f} MB, {S2.n_shards} "
          f"shards): store qPCA == streamed array qPCA bit for bit; "
          f"δ-means fit {ref_s:.3f} s; depth 0 == depth 3; read_fail, "
          f"read_stall, corrupt_shard, cold_tier at depth 3 == clean; "
          f"persistent corruption raised ShardCorruptionError naming shard "
          f"11; read failures tripped the breaker (BreakerOpenError)",
          flush=True)
    return S2, fit_kw


def ooc_kill_case(S2, fit_kw, here, tmp, torch):
    """A child process fits S2 on the card with checkpoints every
    OOC_CKPT_EVERY batches; it is SIGKILLed once a snapshot of epoch 1
    exists, and its rerun resumes and equals an uninterrupted fit bit for
    bit."""
    import signal

    import numpy as np

    from sq_learn_tpu_torch.models import MiniBatchQKMeans

    kw = dict(fit_kw, max_iter=3)
    ref = MiniBatchQKMeans(**kw).fit(S2)
    ckpt_dir = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt_dir)
    snap = os.path.join(ckpt_dir, "oocore_minibatch_fit.npz")
    out = os.path.join(tmp, "child.npz")
    env = dict(os.environ, SQ_STREAM_CKPT_DIR=ckpt_dir,
               SQ_STREAM_CKPT_EVERY=str(OOC_CKPT_EVERY),
               SQ_FAULTS="read_stall:p=1,s=0.05,times=999")
    cmd = [sys.executable, "-c", OOC_CHILD, here, S2.path, out, repr(kw),
           CARD]
    per_epoch = -(-OOC_S2_N // OOC_BATCH)
    t0 = time.perf_counter()
    log = open(os.path.join(tmp, "child.log"), "w+")
    child = subprocess.Popen(cmd, env=env, stdout=log, stderr=log)
    cursor = 0
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and child.poll() is None:
            if os.path.exists(snap):
                try:
                    with np.load(snap) as npz:
                        cursor = int(npz["__cursor__"])
                except (OSError, ValueError, KeyError):
                    cursor = 0  # replaced while read: poll again
                if cursor > per_epoch:
                    break
            time.sleep(0.01)
        if child.poll() is not None:
            log.seek(0)
            check(False, f"the child ended before a snapshot of epoch 1: "
                         f"{log.read()[-2000:]}")
        child.send_signal(signal.SIGKILL)
        check(child.wait() == -signal.SIGKILL, "the child was not killed")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        log.close()
    kill_s = time.perf_counter() - t0
    check(os.path.exists(snap) and not os.path.exists(out),
          "the killed child left no snapshot, or a result")
    env.pop("SQ_FAULTS")
    t0 = time.perf_counter()
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    check(done.returncode == 0, f"the resumed child failed: "
                                f"{done.stderr[-2000:]}")
    with np.load(out) as npz:
        resumed = int(npz["resumed_from"])
        check(resumed > per_epoch, f"the rerun resumed from {resumed}")
        check(np.array_equal(npz["centers"], ref.cluster_centers_)
              and np.array_equal(npz["counts"], ref.counts_)
              and int(npz["n_steps"]) == ref.n_steps_
              and np.array_equal(npz["labels"], ref.labels_),
              "the resumed fit differs from the uninterrupted one")
    check(not os.listdir(ckpt_dir), "the finished fit left snapshots")
    print(f"SIGKILL resume on S2: the child killed at a snapshot of step "
          f"{cursor} (epoch 1) after {kill_s:.3f} s; the rerun resumed "
          f"from step {resumed} and finished in "
          f"{time.perf_counter() - t0:.3f} s bit-equal to the uninterrupted "
          f"fit (centers, counts, n_steps_ {ref.n_steps_}, labels)",
          flush=True)


def ooc_codec_case(tmp, here, torch):
    """S3 under obs: the LZ4 store's round trip, its ratio, its fit
    against the uncompressed twin's, the codec counters; then the obs
    artifact: schema, the storage and trace CLIs, the names."""
    import numpy as np

    from sq_learn_tpu_torch import obs, oocore
    from sq_learn_tpu_torch.models import MiniBatchQKMeans

    path = os.path.join(tmp, "ooc_obs.jsonl")
    rec = obs.enable(path)
    kw = dict(n_classes=OOC_K, seed=OOC_SEED, kind="pixels",
              shard_bytes=OOC_S3_SHARD_BYTES)
    t0 = time.perf_counter()
    S3 = oocore.create_synthetic_store(os.path.join(tmp, "s3"), OOC_S3_N,
                                       OOC_M, codec="lz4", **kw)
    build_s = time.perf_counter() - t0
    twin = oocore.create_synthetic_store(os.path.join(tmp, "s3none"),
                                         OOC_S3_N, OOC_M, codec="none", **kw)
    check(np.array_equal(S3.read_rows(0, OOC_S3_N),
                         twin.read_rows(0, OOC_S3_N)),
          "S3: the LZ4 store's rows differ from its uncompressed twin's")
    ratio = S3.stored_nbytes / S3.nbytes
    check(ratio <= OOC_CODEC_RATIO, f"S3: stored/raw {ratio}")
    fit_kw = dict(n_clusters=OOC_K, batch_size=256, max_iter=2,
                  max_no_improvement=None, delta=WINDOW, random_state=0)
    t0 = time.perf_counter()
    a = MiniBatchQKMeans(**fit_kw).fit(S3)
    fit_s = time.perf_counter() - t0
    b = MiniBatchQKMeans(**fit_kw).fit(twin)
    check(all(np.array_equal(getattr(a, name), getattr(b, name))
              for name in ("cluster_centers_", "counts_", "labels_")),
          "S3: the LZ4 store's fit differs from its twin's")
    obs.disable()
    check(rec.counters.get("oocore.codec_bytes_in", 0) > 0
          and rec.counters.get("oocore.codec_bytes_out", 0)
          > rec.counters["oocore.codec_bytes_in"],
          f"S3: codec counters {rec.counters}")
    errors = obs.schema.validate_jsonl(path)["errors"]
    check(errors == [], f"the out-of-core obs artifact: {errors[:5]}")
    spans = {s["name"] for s in rec.spans
             if s["name"].startswith(("oocore.", "minibatch."))}
    counters = {c for c in rec.counters if c.startswith("oocore.")}
    check(spans <= OOC_SPANS | {"minibatch.fit", "minibatch.partial_fit"}
          and {"oocore.create_store", "oocore.minibatch_fit",
               "oocore.epoch", "oocore.assign_labels",
               "minibatch.fit_store"} <= spans,
          f"out-of-core spans {sorted(spans)}")
    check(counters <= OOC_COUNTERS and {"oocore.shard_reads",
                                        "oocore.codec_bytes_in"} <= counters,
          f"out-of-core counters {sorted(counters)}")
    env = dict(os.environ, PYTHONPATH=here)
    trace_path = os.path.join(tmp, "ooc.trace.json")
    for args in (["storage", path, "--advise"],
                 ["trace", path, "-o", trace_path]):
        done = subprocess.run([sys.executable, "-m",
                               "sq_learn_tpu_torch.obs", *args], env=env,
                              capture_output=True, text=True, timeout=300)
        check(done.returncode == 0,
              f"obs {args[0]} exited {done.returncode}: {done.stderr}")
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    check(any(e.get("cat") == "io" for e in events)
          and any(e.get("name") == "oocore.minibatch_fit" for e in events),
          "the trace holds no io or fit events")
    print(f"S3 {OOC_S3_N}×{OOC_M} pixels, LZ4 in {S3.n_shards} shards: "
          f"built in {build_s:.3f} s, stored/raw {ratio:.4f}, round trip "
          f"bit-equal; δ-means fit {fit_s:.3f} s bit-equal to the "
          f"uncompressed twin's; codec bytes in/out "
          f"{rec.counters['oocore.codec_bytes_in']}/"
          f"{rec.counters['oocore.codec_bytes_out']}; obs artifact: 0 "
          f"schema errors, {len(rec.io_records)} io records, obs storage "
          f"and obs trace exit 0, {len(events)} trace events, names in the "
          f"JAX package's set", flush=True)


def oocore_phase(here, torch):
    """The out-of-core phase (``sq_learn_tpu_torch.oocore``) in a
    temporary directory. Returns the Lloyd kernel's entry for the
    labelling shape."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="sq-ooc-")
    try:
        print(f"out-of-core phase in {tmp}: "
              f"{shutil_free(tmp) / 1e9:.1f} GB free", flush=True)
        entry = ooc_s1_case(tmp, torch)
        S2, fit_kw = ooc_s2_case(tmp, torch)
        ooc_kill_case(S2, fit_kw, here, tmp, torch)
        ooc_codec_case(tmp, here, torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return entry


# ---------------------------------------------------------------------------
# The serving phase (sq_learn_tpu_torch.serving, obs's budget/control/probe)
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 12_000
SERVE_SIZES = (1, 2, 4, 8, 16)
SERVE_CLIENTS = 8
SERVE_WINDOW = 64        # requests each client keeps in flight
SERVE_CAP = 512          # rows per batch, the largest bucket
SERVE_WAIT_MS = 2.0      # the coalescing window
SERVE_ALIASES = 16       # names of alpha for the megabatch leg
SERVE_OPEN_LOOP = 0.5    # the open loop's rate, a share of the batched QPS
LADDER_SIZES = (1, 9, 17, 33, 65, 129, 257)  # one request per bucket 8..512
SERVE_QUANT_REQUESTS = 2_000
SERVE_CONTROL_REQUESTS = 4_000
SERVE_CONTROL_TARGET = 0.5   # tenants' p99 target: this × the static p99
SERVE_SMALL_REQUESTS = 400
# tolerances against float64 (tests/_torch_serving_helpers.py): squared
# center distances within 1e-5·(‖x‖² + ‖c‖²), projections within
# 1e-5·‖x − μ‖; labels held wherever the float64 gap between the two
# nearest squared distances exceeds 3× the measured float32 error
SERVE_DIST_RTOL = 1e-5
SERVE_PROJ_RTOL = 1e-5
SERVE_MARGIN = 3.0

#: the closed loop's request slots, cycled: (tenant, op); "alpha" predicts
#: spread over alpha and its aliases
SERVE_SLOTS = (("alpha", "predict"), ("alpha", "transform"),
               ("gamma", "transform"), ("delta", "transform"),
               ("alpha_bf16", "predict"), ("gamma_bf16", "transform"),
               ("delta_bf16", "transform"), ("alpha_i8", "predict"))


def serving_stream(n, seed, X, Xcov, slots=SERVE_SLOTS, aliases=True):
    """``n`` requests of SERVE_SIZES rows, cycling ``slots``, alternating
    float32 and float64 every cycle; rows drawn from ``X`` (784 wide) or
    ``Xcov`` (the delta tenants). Each entry: (tenant, op, payload, row
    indices)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tenant, op = slots[i % len(slots)]
        if aliases and tenant == "alpha" and op == "predict":
            k = (i // len(slots)) % (SERVE_ALIASES + 1)
            tenant = "alpha" if k == 0 else f"alpha_m{k - 1}"
        src = Xcov if "delta" in tenant else X
        idx = rng.integers(0, src.shape[0],
                           SERVE_SIZES[(i // len(slots)) % len(SERVE_SIZES)])
        rows = src[idx]
        if (i // len(slots)) % 2:
            rows = rows.astype(np.float64)
        out.append((tenant, op, rows, idx))
    return out


def serving_registry(models, device, capacity=64):
    """A registry on ``device`` with alpha, gamma and delta, their bf16
    twins, alpha's int8 twin and SERVE_ALIASES aliases of alpha."""
    from sq_learn_tpu_torch.serving import ModelRegistry

    reg = ModelRegistry(capacity=capacity, device=device)
    for name, est in models.items():
        reg.register(name, est, quantize=None)
        reg.register(f"{name}_bf16", est, quantize="bf16")
    reg.register("alpha_i8", models["alpha"], quantize="int8")
    for k in range(SERVE_ALIASES):
        reg.register(f"alpha_m{k}", models["alpha"], quantize=None)
    return reg


def closed_loop(d, stream, clients=SERVE_CLIENTS, window=SERVE_WINDOW,
                collect=False):
    """Each of ``clients`` threads replays its slice of ``stream`` keeping
    ``window`` requests in flight (one ``submit_many`` per window, then
    every response of it awaited: the JAX package's load-bench client).
    Returns (responses in stream order, wall seconds). With ``collect``
    the heap is collected before the timer starts (the control leg's
    loops only): a full (generation 2) collection of what the earlier
    phases left takes ~250 ms on the card's host, and one landing inside
    one timed loop but not another skews the p99s that leg compares
    across loops."""
    import gc
    import threading

    out = [None] * len(stream)
    errors = []

    def client(c):
        try:
            mine = list(range(c, len(stream), clients))
            for start in range(0, len(mine), window):
                idx = mine[start:start + window]
                futs = d.submit_many([stream[i][:3] for i in idx])
                for i, f in zip(idx, futs):
                    out[i] = f.result(timeout=120)
        except Exception as exc:  # reported below; no thread is lost
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(c,), name=f"client{c}")
               for c in range(clients)]
    if collect:
        gc.collect()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"closed loop: {errors[:3]}")
    return out, wall


def open_loop(d, stream, qps):
    """Submit ``stream`` at ``qps`` requests per second from one thread,
    without waiting; then collect. Returns (responses, wall seconds)."""
    futs = []
    t0 = time.perf_counter()
    for i, (tenant, op, rows, _) in enumerate(stream):
        delay = t0 + i / qps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futs.append(d.submit(tenant, op, rows))
    out = [f.result(timeout=120) for f in futs]
    return out, time.perf_counter() - t0


def _host(v):
    import numpy as np

    return v.detach().cpu().numpy() if hasattr(v, "detach") else \
        np.asarray(v)


def _base(tenant):
    """The fitted model a serving tenant name stands for."""
    for base in ("alpha", "gamma", "delta"):
        if base in tenant:
            return base
    raise KeyError(tenant)


def check_responses(stream, outs, models, refs, what):
    """Every response against float64: labels under the margin rule
    against ``refs["alpha_labels"]`` (alpha's own predict of X's rows),
    center distances and projections within their bounds, quantized
    responses inside their declared fold (``refs["folds"]``). Returns
    (rows held by the margin rule, rows predicted, the float32
    squared-distance error measured on the stream's exact alpha
    transforms)."""
    import numpy as np

    from sq_learn_tpu_torch.serving import quantize

    centers = _host(models["alpha"].cluster_centers_).astype(np.float64)
    csq = (centers * centers).sum(1)
    proj = {}
    for name in ("gamma", "delta"):
        if name in models:
            est = models[name]
            comps = _host(est.components_).astype(np.float64)
            mean = getattr(est, "mean_", None)
            mean = (np.zeros(comps.shape[1]) if mean is None
                    else _host(mean).astype(np.float64))
            proj[name] = (mean, comps)

    def quantized(tenant):
        return tenant.endswith(("_bf16", "_i8")) or (
            tenant, "transform") in refs.get("folds", {}) or (
            tenant, "predict") in refs.get("folds", {})

    sq_err = 0.0
    for (tenant, op, rows, _), out in zip(stream, outs):
        if _base(tenant) == "alpha" and op == "transform" \
                and not quantized(tenant):
            x = np.asarray(rows, np.float32).astype(np.float64)
            d2 = (x * x).sum(1)[:, None] + csq[None] - 2 * x @ centers.T
            err = np.abs(np.asarray(out, np.float64) ** 2 - d2)
            scale = (x * x).sum(1)[:, None] + csq[None]
            check((err <= SERVE_DIST_RTOL * scale).all(),
                  f"{what}: a center distance off float64 by "
                  f"{float((err / scale).max())} of ‖x‖² + ‖c‖²")
            sq_err = max(sq_err, float(err.max()))
    held = predicted = 0
    for (tenant, op, rows, idx), out in zip(stream, outs):
        base = _base(tenant)
        x = np.asarray(rows, np.float32)
        if quantized(tenant):
            fold, amax = refs["folds"][(tenant, op)]
            kernel = ("predict_centers" if op == "predict" else
                      "transform_centers" if base == "alpha"
                      else "transform_components")
            realized = quantize.realized_errors(
                fold.kind, kernel, x, out, refs["host_params"][tenant])
            check(realized <= fold.tol(amax),
                  f"{what}: {tenant} {op} realized error {realized} "
                  f"outside its fold {fold.tol(amax)}")
        elif base == "alpha" and op == "predict":
            x64 = x.astype(np.float64)
            d2 = np.sort((x64 * x64).sum(1)[:, None] + csq[None]
                         - 2 * x64 @ centers.T, axis=1)
            keep = (d2[:, 1] - d2[:, 0]) > SERVE_MARGIN * sq_err
            check(np.array_equal(np.asarray(out)[keep],
                                 refs["alpha_labels"][idx][keep]),
                  f"{what}: {tenant} labels differ from the estimator's "
                  f"predict beyond the margin rule")
            held += int(keep.sum())
            predicted += len(idx)
        elif base in proj:
            mean, comps = proj[base]
            c = x.astype(np.float64) - mean
            err = np.abs(np.asarray(out, np.float64) - c @ comps.T).max(1)
            check((err <= SERVE_PROJ_RTOL * np.linalg.norm(c, axis=1)
                   + 1e-12).all(),
                  f"{what}: a {base} projection off float64 beyond "
                  f"{SERVE_PROJ_RTOL}·‖x − μ‖")
    return held, predicted, sq_err


def serving_refs(reg, stream, alpha_labels):
    """The margin rule's labels and, per quantized (tenant, op) of the
    stream, its fold with the largest batch range the stream can give
    it."""
    import numpy as np

    folds, host_params, amax = {}, {}, {}
    for tenant, op, rows, _ in stream:
        a = float(np.abs(np.asarray(rows, np.float32)).max())
        amax[(tenant, op)] = max(amax.get((tenant, op), 0.0), a)
    for (tenant, op), a in amax.items():
        model = reg.resolve(tenant)
        if model.quant_folds:
            folds[(tenant, op)] = (model.quant_folds[op], a)
            host_params[tenant] = model.host_params
    return {"alpha_labels": alpha_labels, "folds": folds,
            "host_params": host_params}


def replay_tap(entries, torch):
    """Every tapped batch's kernel run again eagerly on the card on the
    same padded batch: bit-equal to what the dispatcher served, and every
    response the batch's own rows of it. Returns the number of batches."""
    import numpy as np

    from sq_learn_tpu_torch.serving import quantize

    view = {np.dtype(np.int16): torch.bfloat16}
    for name, padded, extra, params, out, results in entries:
        tile = torch.from_numpy(padded).to(CARD)
        if padded.dtype in view:
            tile = tile.view(view[padded.dtype])
        again = quantize.KERNELS[name](tile, *extra, *params).cpu().numpy()
        check(again.dtype == out.dtype and again.tobytes() == out.tobytes(),
              f"serving: a served {name} batch of {padded.shape} differs "
              f"from its kernel's eager run on the same padded batch")
        n = sum(len(r) for r in results)
        check(np.concatenate(results).tobytes() == out[:n].tobytes(),
              f"serving: {name} responses are not the batch's rows")
    return len(entries)


def nearest_rank(values, q):
    import math

    ordered = sorted(values)
    return ordered[min(len(ordered), max(1, math.ceil(len(ordered) * q)))
                   - 1]


def serving_cold_start(models, X):
    """The first request per (op, bucket, transfer dtype) on a fresh
    registry, unwarmed and then warmed: wall ms of each. Runs first in
    the phase, before any serving kernel ran at these shapes."""
    from sq_learn_tpu_torch.serving import (MicroBatchDispatcher,
                                            ModelRegistry, aot, cache)

    cases = [(t, op) for t in ("alpha", "alpha_bf16", "alpha_i8")
             for op in ("predict", "transform")]
    times = {}
    for arm in ("unwarmed", "warmed"):
        aot.clear()
        cache.clear()
        reg = ModelRegistry(device=CARD)
        for tenant in ("alpha", "alpha_bf16", "alpha_i8"):
            mode = {"alpha": None, "alpha_bf16": "bf16",
                    "alpha_i8": "int8"}[tenant]
            reg.register(tenant, models["alpha"], quantize=mode)
        d = MicroBatchDispatcher(reg, background=False, autotune=False,
                                 max_batch_rows=SERVE_CAP, max_wait_ms=0)
        if arm == "warmed":
            d.warm()
        else:
            for tenant in ("alpha", "alpha_bf16", "alpha_i8"):
                reg.resolve(tenant)  # resident, no kernel run
        lat = []
        for tenant, op in cases:
            for rows in LADDER_SIZES:
                x = X[:rows]
                t0 = time.perf_counter()
                d.serve(tenant, op, x)
                lat.append(1e3 * (time.perf_counter() - t0))
        stats = d.aot_stats()
        d.close()
        check(stats["misses"] == (len(lat) if arm == "unwarmed" else 0),
              f"cold start {arm}: aot lookups {stats}")
        times[arm] = lat
    return times


def serving_phase(models, alpha_labels, X, Xcov, small, here, torch):
    """The serving plane at full width: alpha (BASELINE #3's q-means,
    70 000 × 784, k=10), gamma (the trial's QPCA(61)) and delta (BASELINE
    #4's TruncatedSVD(10), 54 wide) with their bf16 twins, alpha's int8
    twin and SERVE_ALIASES aliases of alpha, on the card. Returns the
    phase's figures."""
    import numpy as np

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.serving import (MicroBatchDispatcher, aot,
                                            cache, pin_compile_budgets)

    figures = {}
    cache.clear()
    # cold start first, before any serving kernel ran at these shapes
    cold = serving_cold_start(models, X)
    figures["cold_start_p99_ms"] = {arm: nearest_rank(v, 0.99)
                                    for arm, v in cold.items()}
    figures["cold_start_p50_ms"] = {arm: nearest_rank(v, 0.5)
                                    for arm, v in cold.items()}
    print(f"serving cold start, first request per (op, bucket, dtype), "
          f"{len(cold['warmed'])} each: unwarmed p50/p99 "
          f"{figures['cold_start_p50_ms']['unwarmed']:.3f}/"
          f"{figures['cold_start_p99_ms']['unwarmed']:.3f} ms, warmed "
          f"{figures['cold_start_p50_ms']['warmed']:.3f}/"
          f"{figures['cold_start_p99_ms']['warmed']:.3f} ms", flush=True)

    aot.clear()
    reg = serving_registry(models, CARD)
    t0 = time.perf_counter()
    warm = reg.warm()
    warm_s = time.perf_counter() - t0
    check(set(warm.values()) == {"loaded"}, f"registry warm: {warm}")
    pin_compile_budgets(0)
    stream = serving_stream(SERVE_REQUESTS, 11, X, Xcov)
    refs = serving_refs(reg, stream, alpha_labels)
    print(f"serving registry: {len(reg.tenants())} tenants warmed in "
          f"{warm_s:.3f} s, {aot.cache_size()} signatures "
          f"(ladder {aot.bucket_ladder(8, SERVE_CAP)})", flush=True)

    arms = {}
    for arm, coalesce in (("batched", True), ("sequential", False)):
        cache.clear()
        d = MicroBatchDispatcher(reg, max_batch_rows=SERVE_CAP,
                                 max_wait_ms=SERVE_WAIT_MS, autotune=False,
                                 coalesce=coalesce)
        outs, wall = closed_loop(d, stream)
        summary = d.close()
        stats = d.aot_stats()
        check(stats["misses"] == 0,
              f"closed loop {arm}: {stats['misses']} dispatches of an "
              f"unwarmed signature after warm-up")
        check(summary["requests"] == len(stream) and d.failed_batches() == 0,
              f"closed loop {arm}: {summary}")
        held, predicted, sq_err = check_responses(stream, outs, models,
                                                  refs, f"closed loop "
                                                  f"{arm}")
        arms[arm] = dict(qps=len(stream) / wall, wall_s=wall,
                         p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
                         occupancy=summary["batch_occupancy"],
                         batches=summary["batches"],
                         transfer_bytes=summary["transfer_bytes"],
                         megabatches=d.megabatches(), held=held,
                         predicted=predicted, sq_err=sq_err)
        print(f"serving closed loop, {arm} (coalesce={coalesce}): "
              f"{len(stream)} requests from {SERVE_CLIENTS} clients in "
              f"{wall:.3f} s = {arms[arm]['qps']:.1f} QPS, p50 "
              f"{summary['p50_ms']} ms, p99 {summary['p99_ms']} ms, "
              f"{summary['batches']} batches, occupancy "
              f"{summary['batch_occupancy']}, {summary['transfer_bytes']} "
              f"transfer bytes, {d.megabatches()} megabatches, 0 aot "
              f"misses; labels held by the margin rule {held}/{predicted} "
              f"(float32 squared-distance error {sq_err:.3e})", flush=True)
    check(arms["sequential"]["batches"] == len(stream),
          "the sequential arm coalesced")
    check(arms["batched"]["megabatches"] > 0,
          "the aliases of alpha never shared a launch")
    figures["closed_loop"] = arms

    # every response of the same stream, bit for bit against its kernel's
    # eager run on the same padded batch
    cache.clear()
    entries = []
    d = MicroBatchDispatcher(reg, max_batch_rows=SERVE_CAP,
                             max_wait_ms=SERVE_WAIT_MS, autotune=False,
                             tap=lambda *a: entries.append(a))
    outs, _ = closed_loop(d, stream)
    d.close()
    served = {id(r) for e in entries for r in e[5]}
    check(all(id(o) in served for o in outs),
          "a response did not come from a tapped batch")
    figures["replayed_batches"] = replay_tap(entries, torch)
    print(f"serving: all {len(outs)} responses of the stream equal their "
          f"kernels' eager runs on the same padded batches, bit for bit "
          f"({figures['replayed_batches']} batches replayed)", flush=True)
    del entries

    # the open loop, at SERVE_OPEN_LOOP × the batched arm's QPS
    cache.clear()
    qps = SERVE_OPEN_LOOP * arms["batched"]["qps"]
    d = MicroBatchDispatcher(reg, max_batch_rows=SERVE_CAP,
                             max_wait_ms=SERVE_WAIT_MS, autotune=False)
    outs, wall = open_loop(d, stream, qps)
    summary = d.close()
    check(d.aot_stats()["misses"] == 0, "open loop: aot misses")
    check_responses(stream, outs, models, refs, "open loop")
    figures["open_loop"] = dict(offered_qps=qps, qps=len(stream) / wall,
                                p50_ms=summary["p50_ms"],
                                p99_ms=summary["p99_ms"],
                                occupancy=summary["batch_occupancy"],
                                batches=summary["batches"])
    print(f"serving open loop at {qps:.1f} QPS offered: "
          f"{len(stream) / wall:.1f} QPS, p50 {summary['p50_ms']} ms, p99 "
          f"{summary['p99_ms']} ms, {summary['batches']} batches, "
          f"occupancy {summary['batch_occupancy']}", flush=True)

    # quantized: the same replay at float32 and at bf16, audits armed
    env = _env(SQ_SERVE_AUDIT_EVERY=1)
    qstream = serving_stream(SERVE_QUANT_REQUESTS, 12, X, Xcov,
                             slots=(("alpha", "predict"),
                                    ("alpha", "transform")), aliases=False)
    rec = obs.enable()
    nbytes = {}
    try:
        for twin in ("alpha", "alpha_bf16"):
            cache.clear()
            d = MicroBatchDispatcher(reg, background=False, autotune=False,
                                     max_batch_rows=SERVE_CAP)
            twin_stream = [(twin, op, rows, idx)
                           for _, op, rows, idx in qstream]
            futs = [d.submit(t, op, rows) for t, op, rows, _ in twin_stream]
            d.flush()
            outs = [f.result(timeout=60) for f in futs]
            nbytes[twin] = d.close()["transfer_bytes"]
            check_responses(twin_stream, outs, models,
                            serving_refs(reg, twin_stream, alpha_labels),
                            f"quantized replay {twin}")
    finally:
        obs.disable()
        _env(**env)
    draws = [g for g in rec.guarantee_records
             if g["site"].startswith("serving.quant.")]
    check(draws and not any(g["violated"] for g in draws),
          f"quantized replay: {len(draws)} audit draws, "
          f"{sum(g['violated'] for g in draws)} violated")
    figures["bf16_bytes_ratio"] = nbytes["alpha_bf16"] / nbytes["alpha"]
    check(figures["bf16_bytes_ratio"] == 0.5,
          f"bf16 replay moved {figures['bf16_bytes_ratio']} of the float32 "
          f"replay's bytes")
    print(f"serving quantized replay ({len(qstream)} requests): bf16 moved "
          f"{nbytes['alpha_bf16']} bytes against float32's "
          f"{nbytes['alpha']} (ratio {figures['bf16_bytes_ratio']}); "
          f"{len(draws)} live audit draws, none outside its fold", flush=True)

    figures["breaker"] = serving_breaker_leg(reg, stream)
    figures["control"] = serving_control_leg(models, X, Xcov, here)
    pin_compile_budgets(None)

    # a small tenant on the card against the same tenant on the CPU
    from sq_learn_tpu_torch.serving import ModelRegistry

    sstream = serving_stream(SERVE_SMALL_REQUESTS, 13, X, Xcov,
                             slots=(("alpha", "predict"),
                                    ("alpha", "transform")), aliases=False)
    served = {}
    for device in (CARD, "cpu"):
        cache.clear()
        sreg = ModelRegistry(device=device)
        sreg.register("alpha", small, quantize=None)
        d = MicroBatchDispatcher(sreg, background=False, autotune=False)
        futs = [d.submit(t, op, rows) for t, op, rows, _ in sstream]
        d.flush()
        served[device] = [f.result(timeout=60) for f in futs]
        d.close()
    # the card's labels are held against the CPU's under the margin rule
    cpu_labels = {}
    for (t, op, rows, idx), o in zip(sstream, served["cpu"]):
        if op == "predict":
            cpu_labels.update(zip(idx.tolist(), np.asarray(o).tolist()))
    labels = np.full(X.shape[0], -1, np.int64)
    labels[list(cpu_labels)] = list(cpu_labels.values())
    held = {}
    for device in (CARD, "cpu"):
        held[device] = check_responses(sstream, served[device],
                                       {"alpha": small},
                                       {"alpha_labels": labels},
                                       f"small tenant on {device}")
    print(f"serving small tenant {_host(small.cluster_centers_).shape}: "
          f"card == CPU ({held[CARD][0]}/{held[CARD][1]} card labels held "
          f"by the margin rule; transforms of both within "
          f"{SERVE_DIST_RTOL}·(‖x‖² + ‖c‖²) of float64)", flush=True)
    return figures


def serving_breaker_leg(reg, stream):
    """An armed transfer fault trips the breaker: the affected futures
    raise BreakerOpenError, none hangs, no kernel runs (on the card or
    anywhere else) and serving.failed_batches counts them; after the
    cooldown the half-open probe (a fresh subprocess on the card) closes
    the breaker and serving resumes."""
    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.resilience import BreakerOpenError, faults
    from sq_learn_tpu_torch.resilience.supervisor import breaker
    from sq_learn_tpu_torch.serving import MicroBatchDispatcher, cache
    from sq_learn_tpu_torch.serving import quantize

    devices = []
    saved = dict(quantize.KERNELS)

    def counted(fn):
        def run(*args, **kw):
            devices.append(args[0].device.type)
            return fn(*args, **kw)
        return run

    quantize.KERNELS.update({k: counted(fn) for k, fn in saved.items()})
    env = _env(SQ_BREAKER_K=3, SQ_RETRY_MAX=5, SQ_RETRY_BACKOFF_S=0.001,
               SQ_BREAKER_COOLDOWN_S=1.0)
    rec = obs.enable()
    try:
        cache.clear()
        d = MicroBatchDispatcher(reg, background=False, autotune=False,
                                 max_batch_rows=SERVE_CAP)
        faults.arm("put_fail:tiles=0,times=100")
        futs = [d.submit(t, op, rows) for t, op, rows, _ in stream[:16]]
        d.flush()
        faults.disarm()
        errs = [f.exception(timeout=60) for f in futs]
        state = breaker.state()
        failed = d.failed_batches()
        check(all(isinstance(e, BreakerOpenError) for e in errs)
              and state == "open" and not devices,
              f"breaker leg: errors {[type(e).__name__ for e in errs]}, "
              f"state {state}, kernels run on {devices}")
        time.sleep(1.0)  # the cooldown
        t0 = time.perf_counter()
        futs = [d.submit(t, op, rows) for t, op, rows, _ in stream[16:48]]
        d.flush()
        outs = [f.result(timeout=120) for f in futs]
        resume_s = time.perf_counter() - t0
        d.close()
    finally:
        quantize.KERNELS.update(saved)
        faults.disarm()
        obs.disable()
        _env(**env)
    probes = [p["outcome"] for p in rec.probe_events]
    check(breaker.state() == "closed" and probes == ["ok"]
          and set(devices) == {"cuda"} and len(outs) == 32,
          f"breaker leg: state {breaker.state()} after the cooldown, probes "
          f"{probes}, kernels run on {sorted(set(devices))}")
    check(rec.counters.get("serving.failed_batches") == failed > 0,
          f"breaker leg: serving.failed_batches "
          f"{rec.counters.get('serving.failed_batches')} against {failed}")
    breaker.reset("chip_smoke")
    print(f"serving breaker: put failures opened it; {len(errs)} futures "
          f"of {failed} batches raised BreakerOpenError, no kernel ran, "
          f"serving.failed_batches {failed}; after the cooldown the "
          f"half-open probe ({probes[0]}) closed it and 32 requests served "
          f"in {resume_s:.3f} s (probe included)", flush=True)
    return {"failed_batches": failed, "resume_s": resume_s}


def serving_control_leg(models, X, Xcov, here):
    """Tenants declare p99 targets of SERVE_CONTROL_TARGET × the static
    arm's measured p99 plus (ε, δ) headroom. The static arm (autotune=False) trips
    at least one alert; the controller arm none, at a lower summed
    theoretical cost. Both artifacts validate with 0 schema errors and
    ``python -m sq_learn_tpu_torch.obs report|budget|control`` exit 0 on
    the controller's."""
    import shutil
    import tempfile

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.serving import (MicroBatchDispatcher,
                                            ModelRegistry, cache)
    from sq_learn_tpu_torch.serving.control import theoretical_cost

    declared = {"ctl_alpha": (0.01, 1e-3), "ctl_gamma": (0.01, 1e-3),
                "ctl_delta": (None, 1e-3)}
    slots = (("ctl_alpha", "predict"), ("ctl_alpha", "transform"),
             ("ctl_gamma", "transform"), ("ctl_delta", "transform"))
    stream = serving_stream(SERVE_CONTROL_REQUESTS, 14, X, Xcov, slots=slots,
                            aliases=False)
    # the static arm's p99 without targets sets the targets
    reg = ModelRegistry(device=CARD)
    for tenant in declared:
        reg.register(tenant, models[_base(tenant)], quantize=None)
    cache.clear()
    d = MicroBatchDispatcher(reg, max_batch_rows=SERVE_CAP,
                             max_wait_ms=SERVE_WAIT_MS, autotune=False)
    d.warm()
    closed_loop(d, stream, collect=True)
    target = SERVE_CONTROL_TARGET * d.close()["p99_ms"]
    tmp = tempfile.mkdtemp(prefix="sq-serve-")
    out = {}
    try:
        for arm, autotune in (("static", False), ("controller", True)):
            path = os.path.join(tmp, f"{arm}.jsonl")
            rec = obs.enable(path)
            reg = ModelRegistry(device=CARD)
            ctl = reg.controller() if autotune else None
            for tenant, (eps, delta) in declared.items():
                reg.register(tenant, models[_base(tenant)], quantize=None,
                             slo_p99_ms=target, slo_eps=eps,
                             slo_delta=delta)
            cache.clear()
            d = MicroBatchDispatcher(reg, max_batch_rows=SERVE_CAP,
                                     max_wait_ms=SERVE_WAIT_MS,
                                     autotune=autotune, autotune_every=8)
            d.warm()
            _, wall = closed_loop(d, stream, collect=True)
            summary = d.close()
            obs.disable()
            if ctl is None:
                cost = sum(theoretical_cost(delta) for _, delta
                           in declared.values())
            else:
                cost = sum(c["cost_served"]
                           for c in ctl.contracts().values())
            valid = obs.schema.validate_jsonl(path)
            actions = {}
            for r in rec.control_records:
                actions[r["action"]] = actions.get(r["action"], 0) + 1
            out[arm] = dict(alerts=len(rec.alert_records), cost=cost,
                            p99_ms=summary["p99_ms"],
                            qps=len(stream) / wall, actions=actions,
                            errors=valid["errors"], path=path)
            check(not valid["errors"],
                  f"control leg {arm}: schema errors {valid['errors'][:3]}")
            print(f"serving control, {arm} arm: p99 {summary['p99_ms']:.3f} "
                  f"ms against the target {target:.3f} ms, "
                  f"{out[arm]['alerts']} alerts", flush=True)
        check(out["static"]["alerts"] >= 1,
              "control leg: the static arm tripped no alert")
        check(out["controller"]["alerts"] == 0,
              f"control leg: the controller arm tripped "
              f"{out['controller']['alerts']} alerts")
        check(out["controller"]["cost"] < out["static"]["cost"],
              f"control leg: summed theoretical cost "
              f"{out['controller']['cost']} not under the static "
              f"{out['static']['cost']}")
        env = dict(os.environ, PYTHONPATH=here)
        codes = {}
        for cmd in ("report", "budget", "control"):
            res = subprocess.run(
                [sys.executable, "-m", "sq_learn_tpu_torch.obs", cmd,
                 out["controller"]["path"]], cwd=here, env=env,
                capture_output=True, text=True, timeout=120)
            codes[cmd] = res.returncode
        check(set(codes.values()) == {0},
              f"control leg: obs CLIs on the controller's artifact {codes}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serving control: p99 targets {target:.3f} ms; static arm "
          f"{out['static']['alerts']} alerts, summed theoretical cost "
          f"{out['static']['cost']:.6g}; controller arm "
          f"{out['controller']['alerts']} alerts, cost "
          f"{out['controller']['cost']:.6g}, actions "
          f"{out['controller']['actions']}; 0 schema errors; obs report/"
          f"budget/control exit {codes}", flush=True)
    for arm in out.values():
        arm.pop("path")
        arm.pop("errors")
    return out


# -- the mesh phase ---------------------------------------------------------

MESH_SHARDS = 4
# the mesh's δ=0 fit against the single-device fit: the same labels, the
# inertia summed in another order
MESH_INERTIA_RTOL = 1e-4
# TruncatedSVD(10, mesh=...) on the covertype surrogate: singular values
# within 3× the JAX package's float32 error of its mesh route (the sharded
# Gram route over 8 CPU devices) against float64 on the same data
# (python tests/test_torch_parallel_pca.py)
JAX_MESH_SVD_ERR = 3.896713329429239e-06


def mesh_kernel_shapes(Xc, Xd, torch):
    """Both kernels at the 4-shard mesh's shard shapes, held against
    their plain versions and timed: the Lloyd step on a quarter of the
    centered rows (17 500 × 784, k=10, R=1) at window 0 and 0.5, and the
    search of the 10 000 queries against a quarter of the 60 000 training
    rows (10 000 × 15 000 × 784, k=7). Returns their shape entries; the
    phase fills in their launches."""
    per = N // MESH_SHARDS
    Xs = Xc[:per].contiguous()
    operands = lloyd_operands(Xs, K, 1, torch)
    cases = [("float32", Xs, None, 0.0, True),
             ("float32", Xs, operands["gum"], WINDOW, True)]
    report = hold_lloyd_cases(cases, operands, torch)
    main = report[("float32", WINDOW)]
    lloyd = {"shape": f"{per}x{M} k={K} R=1 (mesh shard)", "window": WINDOW,
             "launches": None, "max_abs_err": max(main["err"].values()),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "window_0_ms": report[("float32", 0.0)]["ms"],
             "window_0_plain_ms": report[("float32", 0.0)]["plain_ms"]}
    T = Xd[:N_TRAIN // MESH_SHARDS].contiguous()
    Q = Xd[N_TRAIN:].contiguous()
    knn = argkmin_fold_case(T, torch.sum(T * T, dim=1), Q, KNN_K, None,
                            torch, path="the mesh phase")
    knn["shape"] += " (mesh shard)"
    return lloyd, knn


def _timed(fn, torch, tally, shards):
    """(fn's result, seconds, lloyd_step launches, argkmin launches) of
    one run on ``shards`` shards (1 for a single-device run); the
    launches are added to ``tally[shards]`` (None: a process of its
    own, whose launches no entry counts)."""
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    before = (lloyd_step.launches, argkmin.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    lloyd, knn = (lloyd_step.launches - before[0],
                  argkmin.launches - before[1])
    if tally is not None:
        tally[shards][0] += lloyd
        tally[shards][1] += knn
    return out, time.perf_counter() - t0, lloyd, knn


def class_init(X, y):
    """An array init of one row of each class (the first): a start whose
    centers lie in different clusters, so no boundary runs through a
    cluster where summing in another order could move a row."""
    import numpy as np

    return X[[int(np.flatnonzero(y == c)[0]) for c in range(K)]]


def mesh_qkmeans_case(X, y, est, mesh, tally, torch):
    """q-means at BASELINE #3's shape on the mesh: the sharded init, the
    δ=0 fits (k-means++ and an array init) against the single-device
    ones, and the δ=0.5 δ-means fit against the classes and ``est`` (the
    single-device δ-means fit)."""
    import numpy as np

    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.parallel import kmeans_plusplus_sharded
    from sq_learn_tpu_torch.parallel.init import kmeans_plusplus_batched
    from sq_learn_tpu_torch.utils import as_generator

    Xd = torch.from_numpy(X).to(CARD)
    Xc = Xd - Xd.mean(dim=0)
    xsq = torch.sum(Xc * Xc, dim=1)
    c1, i1 = kmeans_plusplus_batched(as_generator(0, CARD), Xc, xsq, K,
                                     n_restarts=10)
    (cs, i_s), init_s, _, _ = _timed(lambda: kmeans_plusplus_sharded(
        mesh, as_generator(0, CARD), Xc, xsq, K, n_restarts=10), torch,
        tally, mesh.size)
    check(bool(torch.equal(i1, i_s) and torch.equal(c1, cs)),
          "the sharded k-means++ init's indices differ from the "
          "single-device init's")
    print(f"kmeans_plusplus_sharded on {MESH_SHARDS} shards, 10 restarts "
          f"of {K} centers at {N}×{M}: {init_s:.4f} s, indices equal to "
          f"the single-device init's from the same generator", flush=True)
    del Xd, Xc, xsq
    for what, kw in (("k-means++", dict(n_init=10, init_subsample=0)),
                     ("array init", dict(init=class_init(X, y)))):
        fits = {}
        for name, m in (("single", None), ("mesh", mesh)):
            fits[name] = _timed(lambda: QKMeans(
                n_clusters=K, delta=0.0, random_state=0, mesh=m,
                **kw).fit(X), torch, tally, 1 if m is None else m.size)
        single, mesh_fit = fits["single"][0], fits["mesh"][0]
        rel = abs(mesh_fit.inertia_ - single.inertia_) / single.inertia_
        check(ari(single.labels_, mesh_fit.labels_) == 1.0
              and rel <= MESH_INERTIA_RTOL,
              f"δ=0 {what} fit on the mesh: ARI "
              f"{ari(single.labels_, mesh_fit.labels_)} against the "
              f"single-device fit, inertia off by {rel} (relative)")
        if what == "array init":
            check(np.array_equal(single.labels_, mesh_fit.labels_)
                  and single.n_iter_ == mesh_fit.n_iter_,
                  "δ=0 array-init fit on the mesh: labels or n_iter differ "
                  "from the single-device fit")
        launches = fits["mesh"][2]
        check(launches > 0 and launches % MESH_SHARDS == 0,
              f"δ=0 {what} mesh fit: {launches} lloyd_step launches")
        print(f"QKMeans δ=0 {what} {N}×{M} on {MESH_SHARDS} shards: "
              f"{fits['mesh'][1]:.4f} s against {fits['single'][1]:.4f} s "
              f"on one device (ratio "
              f"{fits['mesh'][1] / fits['single'][1]:.3f}), n_iter "
              f"{mesh_fit.n_iter_} (single {single.n_iter_}), lloyd_step "
              f"launches {launches // MESH_SHARDS} per shard (single "
              f"{fits['single'][2]}), ARI 1.0 against the single-device "
              f"fit, inertia within {rel} (relative)", flush=True)
    delta_fit, wall, launches, _ = _timed(lambda: QKMeans(
        n_clusters=K, n_init=10, delta=WINDOW, true_distance_estimate=False,
        random_state=0, mesh=mesh).fit(X), torch, tally, mesh.size)
    to_y, to_single = ari(y, delta_fit.labels_), ari(est.labels_,
                                                     delta_fit.labels_)
    check(min(to_y, to_single) >= ARI_FLOOR and launches > 0
          and np.isfinite(delta_fit.condition_number_),
          f"δ-means on the mesh: ARI {to_y} to the classes, {to_single} to "
          f"the single-device fit (floor {ARI_FLOOR}), {launches} launches")
    print(f"QKMeans δ={WINDOW} δ-means {N}×{M} on {MESH_SHARDS} shards: "
          f"{wall:.4f} s, n_iter {delta_fit.n_iter_}, lloyd_step launches "
          f"{launches // MESH_SHARDS} per shard, ARI {to_y} to the classes "
          f"and {to_single} to the single-device fit, exact κ "
          f"{delta_fit.condition_number_}", flush=True)


def mesh_qpca_case(X, mesh, tally, torch):
    """QPCA(61) with every top-k estimator on the mesh, on the trial's
    data: the spectrum against float64, the Gaussian tomography of the
    top-k vectors within δ, and the quantum transform (each shard draws
    its rows' estimates) within δ of the projection."""
    import numpy as np

    from sq_learn_tpu_torch.models import QPCA

    fit_kw = dict(estimate_all=True, eps=QPCA_EPS, delta=QPCA_DELTA,
                  theta_major=QPCA_THETA, true_tomography=False)
    _, single_s, _, _ = _timed(lambda: QPCA(
        n_components=QPCA_COMPONENTS, svd_solver="full",
        random_state=0).fit(X, **fit_kw), torch, tally, 1)
    pca, wall, _, _ = _timed(lambda: QPCA(
        n_components=QPCA_COMPONENTS, svd_solver="full", random_state=0,
        mesh=mesh).fit(X, **fit_kw), torch, tally, mesh.size)
    X64 = torch.from_numpy(X).to(CARD).double()
    X64 -= X64.mean(dim=0)
    ev64 = torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:QPCA_COMPONENTS]
    ev64 = (ev64 / (N - 1)).cpu().numpy()
    del X64
    rel = float(np.max(np.abs(pca.explained_variance_ - ev64) / ev64))
    check(pca.topk == QPCA_COMPONENTS and rel <= SPECTRUM_RTOL,
          f"QPCA on the mesh: topk {pca.topk}, spectrum off float64 by "
          f"{rel} (limit {SPECTRUM_RTOL})")
    for side, est_v, true_v in (
            ("right", pca.estimate_right_sv, pca.components_),
            ("left", pca.estimate_left_sv, pca.left_sv)):
        err = float(np.linalg.norm(est_v - true_v, axis=1).max())
        check(err <= QPCA_DELTA, f"QPCA on the mesh: Gaussian tomography "
                                 f"of the {side} vectors off by {err}")
    proj = pca.transform(X, classic_transform=False)
    out, t_s, _, _ = _timed(lambda: pca.transform(
        X, classic_transform=False, quantum_representation=True,
        epsilon_delta=QPCA_DELTA, psi=QPCA_DELTA, norm="None",
        true_tomography=False), torch, tally, mesh.size)
    Yq = out["quantum_representation_results"]
    f_err = float(torch.linalg.norm(Yq - proj))
    check(tuple(Yq.shape) == (N, QPCA_COMPONENTS) and Yq.is_cuda
          and bool(torch.isfinite(Yq).all()) and 0.0 < f_err <= QPCA_DELTA,
          f"QPCA on the mesh: the quantum transform's ‖Ŷ − Y‖_F {f_err} "
          f"(δ = {QPCA_DELTA})")
    print(f"QPCA(n_components={QPCA_COMPONENTS}) on {MESH_SHARDS} shards, "
          f"every top-k estimator {N}×{M}: fit {wall:.4f} s against "
          f"{single_s:.4f} s on one device (ratio {wall / single_s:.3f}); "
          f"explained "
          f"variance off float64 by {rel} (limit {SPECTRUM_RTOL}); muA "
          f"{pca.muA} ({pca.norm_muA}, the exact sweep); quantum transform "
          f"(sharded tomography) {t_s:.4f} s, ‖Ŷ − Y‖_F {f_err} ≤ δ = "
          f"{QPCA_DELTA}", flush=True)


def mesh_knn_case(X, y, mesh, tally, torch):
    """7-NN fitted on 60 000 rows, predicting 10 000, on the mesh: one
    ``argkmin_short`` launch per shard per search, the single-device
    lists."""
    import numpy as np

    from sq_learn_tpu_torch.models import KNeighborsClassifier
    from sq_learn_tpu_torch.ops.kernels import argkmin_route

    check(argkmin_route(KNN_K, torch.device(CARD)) == "short",
          f"k={KNN_K} must take argkmin_short")
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    single = KNeighborsClassifier(n_neighbors=KNN_K).fit(Xtr, ytr)
    (d_ref, i_ref), single_s, _, _ = _timed(lambda: single.kneighbors(Xte),
                                            torch, tally, 1)
    meshed = KNeighborsClassifier(n_neighbors=KNN_K, mesh=mesh).fit(Xtr, ytr)
    pred, pred_s, _, launches = _timed(lambda: meshed.predict(Xte), torch,
                                       tally, mesh.size)
    check(launches == MESH_SHARDS,
          f"a 7-NN predict on {MESH_SHARDS} shards launched argkmin "
          f"{launches} times")
    (d, i), knn_s, _, launches = _timed(lambda: meshed.kneighbors(Xte),
                                        torch, tally, mesh.size)
    check(launches == MESH_SHARDS and np.array_equal(i, i_ref)
          and np.allclose(d, d_ref, rtol=1e-5, atol=1e-5),
          f"7-NN on the mesh: {int((i != i_ref).sum())} indices differ from "
          f"the single-device search ({launches} launches)")
    acc = float(np.mean(pred == yte))
    check(acc >= KNN_ACCURACY_FLOOR, f"7-NN on the mesh: accuracy {acc}")
    print(f"KNeighborsClassifier({KNN_K}) on {MESH_SHARDS} shards, "
          f"{N_TRAIN}×{M} → {N - N_TRAIN} queries: predict {pred_s:.4f} s, "
          f"kneighbors {knn_s:.4f} s against {single_s:.4f} s on one device "
          f"(ratio {knn_s / single_s:.3f}); argkmin_short launches 1 per "
          f"shard per search; lists equal to the single-device search; "
          f"accuracy {acc}", flush=True)


def mesh_svd_case(Xcov, mesh, tally, torch):
    """TruncatedSVD(10) on the covertype surrogate over the mesh (the
    sharded Gram route) against a float64 spectrum made on the card."""
    import numpy as np

    from sq_learn_tpu_torch.decomposition import TruncatedSVD

    X64 = torch.from_numpy(Xcov).to(CARD).double()
    s64 = torch.sqrt(torch.linalg.eigvalsh(X64.T @ X64).flip(0)[:SVD_K])
    s64 = s64.cpu().numpy()
    del X64
    _, single_s, _, _ = _timed(lambda: TruncatedSVD(
        n_components=SVD_K, algorithm="arpack").fit(Xcov), torch, tally, 1)
    est, wall, _, _ = _timed(lambda: TruncatedSVD(
        n_components=SVD_K, mesh=mesh).fit(Xcov), torch, tally, mesh.size)
    err = float(np.max(np.abs(est.singular_values_ - s64) / s64))
    comps = est.components_.astype(np.float64)
    orth = float(np.abs(comps @ comps.T - np.eye(SVD_K)).max())
    check(err <= 3 * JAX_MESH_SVD_ERR and orth <= ORTHONORMAL_ATOL,
          f"TruncatedSVD on the mesh: singular values {err} off float64 "
          f"(limit {3 * JAX_MESH_SVD_ERR}), components orthonormal within "
          f"{orth}")
    print(f"TruncatedSVD({SVD_K}) on {MESH_SHARDS} shards "
          f"{COVTYPE_N}×{COVTYPE_M}: {wall:.4f} s against {single_s:.4f} s "
          f"for the exact fit on one device (ratio {wall / single_s:.3f}), "
          f"singular values within "
          f"{err} of float64 (limit {3 * JAX_MESH_SVD_ERR}), components "
          f"orthonormal within {orth}", flush=True)


def mesh_stream_case(X, mesh, tally, torch):
    """The streamed sharded Gram at STREAM_TILE_BYTES: a pass with one
    retried tile bit-equal to a clean pass, both near the single-device
    streamed Gram."""
    from sq_learn_tpu_torch.parallel.streaming import \
        streamed_centered_gram_sharded
    from sq_learn_tpu_torch.resilience import faults
    from sq_learn_tpu_torch.streaming import streamed_centered_gram

    (mean, G, _), wall, _, _ = _timed(lambda: streamed_centered_gram_sharded(
        mesh, X, max_bytes=STREAM_TILE_BYTES), torch, tally, mesh.size)
    faults.arm("put_fail:tiles=3,times=1")
    try:
        mean_r, G_r, _ = streamed_centered_gram_sharded(
            mesh, X, max_bytes=STREAM_TILE_BYTES)
    finally:
        plan = faults.disarm()
    check(len(plan.events) == 1, f"the armed put_fail fired "
                                 f"{len(plan.events)} times, not once")
    check(bool(torch.equal(mean, mean_r) and torch.equal(G, G_r)),
          "the streamed sharded Gram with a retried tile differs from a "
          "clean pass")
    (_, G1, _), single_s, _, _ = _timed(lambda: streamed_centered_gram(
        X, max_bytes=STREAM_TILE_BYTES, device=CARD), torch, tally, 1)
    rel = float((G - G1).abs().max() / G1.abs().max())
    check(rel <= 1e-4, f"streamed sharded Gram off the single-device one by "
                       f"{rel} (relative to its largest entry)")
    print(f"streamed sharded Gram {N}×{M} on {MESH_SHARDS} shards at "
          f"{STREAM_TILE_BYTES >> 20} MiB tiles: {wall:.4f} s against "
          f"{single_s:.4f} s on one device (ratio {wall / single_s:.3f}); "
          f"with tile 3's "
          f"put failed once: bit-equal to the clean pass; within {rel} of "
          f"the single-device streamed Gram", flush=True)


def mesh_world_case(X, y, tally, torch):
    """A one-process NCCL world over a TCP store on localhost: its
    ``global_mesh()`` δ=0 fit bit-equal to the in-process 1-shard mesh's."""
    import socket

    import numpy as np

    from sq_learn_tpu_torch.models import QKMeans
    from sq_learn_tpu_torch.parallel import distributed as dist
    from sq_learn_tpu_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init = class_init(X, y)
    t0 = time.perf_counter()
    dist.initialize(f"localhost:{port}", 1, 0, devices=[CARD])
    try:
        world_mesh = dist.global_mesh()
        check(dist._WORLD["backend"] == "nccl" and world_mesh.size == 1,
              f"the one-process world: backend {dist._WORLD['backend']}, "
              f"{world_mesh.size} shards")
        world, wall, launches, _ = _timed(lambda: QKMeans(
            n_clusters=K, init=init, delta=0.0, mesh=world_mesh).fit(X),
            torch, tally, world_mesh.size)
    finally:
        dist.shutdown()
    init_s = time.perf_counter() - t0 - wall
    local, _, _, _ = _timed(lambda: QKMeans(
        n_clusters=K, init=init, delta=0.0, mesh=make_mesh([CARD])).fit(X),
        torch, tally, 1)
    check(np.array_equal(world.labels_, local.labels_)
          and np.array_equal(world.cluster_centers_, local.cluster_centers_)
          and world.inertia_ == local.inertia_
          and world.n_iter_ == local.n_iter_ and launches > 0,
          "the one-process NCCL world's fit differs from the in-process "
          "1-shard mesh's")
    print(f"one-process NCCL world (tcp://localhost:{port}): δ=0 fit on "
          f"global_mesh() {wall:.4f} s, {launches} lloyd_step launches, "
          f"bit-equal to the in-process 1-shard mesh; world set-up and "
          f"teardown {init_s:.4f} s", flush=True)


def cards_fits(X, y, mesh, tally, torch, warm=False):
    """The δ=0 fits (an array init and k-means++ × 10) and the timed 7-NN
    kneighbors of the 10 000 queries on ``mesh``: their labels, centers,
    lists and wall clocks. ``warm`` runs a 100-query search first (a
    process of its own loads the kernel there)."""
    from sq_learn_tpu_torch.models import KNeighborsClassifier, QKMeans

    out = {}
    for name, kw in (("array", dict(init=class_init(X, y))),
                     ("kpp", dict(n_init=10, init_subsample=0,
                                  random_state=0))):
        km, out[f"{name}_s"], _, _ = _timed(lambda: QKMeans(
            n_clusters=K, delta=0.0, mesh=mesh, **kw).fit(X), torch, tally,
            mesh.size)
        out[f"{name}_labels"] = km.labels_
        out[f"{name}_centers"] = km.cluster_centers_
    knn = KNeighborsClassifier(n_neighbors=KNN_K, mesh=mesh).fit(
        X[:N_TRAIN], y[:N_TRAIN])
    if warm:
        knn.kneighbors(X[N_TRAIN:N_TRAIN + 100])
    (out["knn_d"], out["knn_idx"]), out["knn_s"], _, _ = _timed(
        lambda: knn.kneighbors(X[N_TRAIN:]), torch, tally, mesh.size)
    return out


def world_worker(rank, world, port, outdir, here):
    """One process of a ``world``-process NCCL world, one shard each on
    ``cuda:<rank>``: :func:`cards_fits` on ``global_mesh()``, written to
    ``<outdir>/world<rank>.npz``."""
    import numpy as np
    import torch

    sys.path.insert(0, here)
    import sq_learn_tpu_torch as sqt
    from sq_learn_tpu_torch.datasets import synthetic_surrogate
    from sq_learn_tpu_torch.parallel import distributed as dist

    dev = f"cuda:{rank}"
    torch.cuda.set_device(dev)
    sqt.set_config(device=dev)
    X, y = synthetic_surrogate(N, M, K, seed=784)
    dist.initialize(f"localhost:{port}", world, rank, devices=[dev])
    try:
        out = cards_fits(X, y, dist.global_mesh(), None, torch, warm=True)
    finally:
        dist.shutdown()
    np.savez(os.path.join(outdir, f"world{rank}.npz"), **out)
    return 0


def cards_world(count):
    """:func:`world_worker` in ``count`` processes, one per card, over a
    TCP store on localhost. Returns (each rank's results, seconds with
    start-up)."""
    import socket
    import tempfile

    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--world-worker", str(r), str(count), str(port), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(count)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world_s = time.perf_counter() - t0
        check(all(p.returncode == 0 for p in procs),
              "a world worker failed:\n" + "\n".join(logs)[-4000:])
        worlds = [dict(np.load(os.path.join(tmp, f"world{r}.npz")))
                  for r in range(count)]
    return worlds, world_s


def mesh_cards_case(X, y, tally, torch):
    """Where more than one card is visible: the δ=0 fits and the 7-NN
    search over every card, in this process and as a world of one NCCL
    process per card, bit-equal to as many shards on cuda:0."""
    import numpy as np

    from sq_learn_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        print(f"meshes run: {MESH_SHARDS} shards on {CARD}, 1 shard in a "
              f"one-process world; one card visible, so no mesh over "
              f"several cards", flush=True)
        return
    runs = {"cards": cards_fits(X, y, make_mesh(), tally, torch),
            "one card": cards_fits(X, y, make_mesh([CARD] * count), tally,
                                   torch)}
    worlds, world_s = cards_world(count)
    ref = runs["one card"]
    for name, got in [("cards", runs["cards"])] + [
            (f"world rank {r}", w) for r, w in enumerate(worlds)]:
        for key in ("array_labels", "array_centers", "kpp_labels",
                    "kpp_centers", "knn_idx", "knn_d"):
            check(np.array_equal(got[key], ref[key]),
                  f"{name}: {key} differs from {count} shards on {CARD}")
    for key, what in (("array_s", "δ=0 fit, array init"),
                      ("kpp_s", "δ=0 fit, k-means++ × 10"),
                      ("knn_s", "7-NN kneighbors of 10 000 rows")):
        print(f"{what} {N}×{M}: {count} cards in one process "
              f"{runs['cards'][key]:.4f} s; {count} shards on {CARD} "
              f"{ref[key]:.4f} s; a world of {count} processes over NCCL "
              f"{max(float(w[key]) for w in worlds):.4f} s (slowest rank)",
              flush=True)
    print(f"meshes run: {MESH_SHARDS} shards on {CARD}, 1 shard in a "
          f"one-process world, {count} cards in one process and a world of "
          f"{count} NCCL processes ({world_s:.3f} s with start-up): labels, "
          f"centers and neighbor lists bit-equal to {count} shards on "
          f"{CARD}", flush=True)


def mesh_phase(X, y, est, Xcov, torch):
    """The mesh paths on ``make_mesh([CARD] * MESH_SHARDS)``. Returns the
    phase's launches by shard count, ``{shards: [lloyd_step, argkmin]}``
    (1: the single-device and 1-shard runs held against), every launch
    of the phase counted once."""
    import collections

    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step
    from sq_learn_tpu_torch.parallel import make_mesh

    tally = collections.defaultdict(lambda: [0, 0])
    mesh = make_mesh([CARD] * MESH_SHARDS)
    mesh_qkmeans_case(X, y, est, mesh, tally, torch)
    mesh_qpca_case(X, mesh, tally, torch)
    mesh_knn_case(X, y, mesh, tally, torch)
    mesh_svd_case(Xcov, mesh, tally, torch)
    mesh_stream_case(X, mesh, tally, torch)
    mesh_world_case(X, y, tally, torch)
    mesh_cards_case(X, y, tally, torch)
    counted = [sum(t[j] for t in tally.values()) for j in (0, 1)]
    check(counted == [lloyd_step.launches, argkmin.launches],
          f"the mesh phase's runs counted {counted} launches, the kernels "
          f"{[lloyd_step.launches, argkmin.launches]}")
    return dict(tally)


# -- the elastic phase -------------------------------------------------------
# The window-synchronous q-means fold over S2 (store_from_array of
# synthetic_surrogate(100 000, 784, 10, seed=784): 313.6 MB, 38 shards of
# 2 675 rows at the default 8 MiB): k=10, 2 epochs, windows of 4 shards
# (10 a pass, 20 in all), seed 0. Worker 1 of the 3-worker world is
# SIGKILLed once the first window is committed.
ELASTIC_K, ELASTIC_EPOCHS, ELASTIC_WINDOW, ELASTIC_SEED = 10, 2, 4, 0
ELASTIC_WINDOWS = ELASTIC_EPOCHS * -(-ooc_shards(OOC_S2_N) // ELASTIC_WINDOW)
# shards held card against CPU: the first, a middle one, the ragged last
ELASTIC_SHARDS = (0, 19, ooc_shards(OOC_S2_N) - 1)
# a shard's float64 sums and inertia, card against CPU: another summation
# order over ≤ 2 675 rows of 784 (both float64, so ~1e-15 apart)
ELASTIC_PARTIAL_RTOL = 1e-12
ELASTIC_KILL = (1, ELASTIC_WINDOW)
ELASTIC_FAULT = "host_fail:window=5,host=1,times=1"
ELASTIC_TIMEOUT_S = 300
# the fleet's clock offsets on one host (true offset 0): bounded by the
# coordinator's 50 ms progress poll and the 0.5 s heartbeat cadence
ELASTIC_CLOCK_SKEW_S = 0.5


def elastic_partial_case(store, torch):
    """``shard_partial`` on the card against its CPU run on three shards:
    counts and labels equal, sums and inertia within ELASTIC_PARTIAL_RTOL;
    one shard's partial timed on the card. Returns (ms, plain CPU ms)."""
    import numpy as np

    from sq_learn_tpu_torch.parallel import elastic

    C = elastic.init_centers(store, ELASTIC_K, ELASTIC_SEED)
    worst = 0.0
    for s in ELASTIC_SHARDS:
        rows = store.read_shard(s)
        card = elastic.shard_partial(C, rows, device=CARD,
                                     return_labels=True)
        cpu = elastic.shard_partial(C, rows, device="cpu",
                                    return_labels=True)
        check(np.array_equal(card[0], cpu[0])
              and np.array_equal(card[3], cpu[3]),
              f"elastic: shard {s}'s partial counts or labels differ card "
              f"against CPU")
        rel = max(float(np.max(np.abs(card[1] - cpu[1]))
                        / np.max(np.abs(cpu[1]))),
                  abs(card[2] - cpu[2]) / abs(cpu[2]))
        check(rel <= ELASTIC_PARTIAL_RTOL,
              f"elastic: shard {s}'s partial sums/inertia off the CPU run "
              f"by {rel} (limit {ELASTIC_PARTIAL_RTOL})")
        worst = max(worst, rel)
    rows = store.read_shard(ELASTIC_SHARDS[0])
    ms = time_ms(lambda: elastic.shard_partial(C, rows, device=CARD))
    t0 = time.perf_counter()
    elastic.shard_partial(C, rows, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    print(f"elastic shard_partial ({rows.shape[0]}×{rows.shape[1]}, "
          f"k={ELASTIC_K}, float64) on shards {ELASTIC_SHARDS}: card == CPU "
          f"(counts, labels), sums and inertia within {worst} (limit "
          f"{ELASTIC_PARTIAL_RTOL}); {ms:.4f} ms per shard on the card "
          f"(with its upload and read-back), {cpu_ms:.1f} ms on the CPU",
          flush=True)
    return ms, cpu_ms


def _same_fold(a, b):
    import numpy as np

    return (all(np.array_equal(a[key], b[key])
                for key in ("centers", "counts", "folds"))
            and a["inertia"] == b["inertia"])


def elastic_sim_case(store):
    """``elastic_fit_local`` on the card at 1, 2 and 3 hosts, then with
    ELASTIC_FAULT (3 → 2): the same state, bit for bit. Returns the
    reference state and the 1-host fit's milliseconds per window."""
    from sq_learn_tpu_torch.parallel import elastic
    from sq_learn_tpu_torch.resilience import faults

    kw = dict(seed=ELASTIC_SEED, epochs=ELASTIC_EPOCHS,
              window=ELASTIC_WINDOW, device=CARD)
    runs, walls = {}, {}
    for n in (1, 2, 3):
        t0 = time.perf_counter()
        runs[n] = elastic.elastic_fit_local(store, ELASTIC_K, n_hosts=n,
                                            **kw)
        walls[n] = time.perf_counter() - t0
    faults.arm(ELASTIC_FAULT)
    try:
        t0 = time.perf_counter()
        shrunk = elastic.elastic_fit_local(store, ELASTIC_K, n_hosts=3,
                                           **kw)
        walls["fault"] = time.perf_counter() - t0
    finally:
        faults.disarm()
    ref = runs[1]
    check(all(_same_fold(runs[n], ref) for n in (2, 3)),
          "elastic: the simulator's state depends on the host count")
    check((shrunk["generation"], shrunk["n_hosts"], shrunk["shrinks"])
          == (1, 2, 1) and _same_fold(shrunk, ref),
          f"elastic: the simulator with {ELASTIC_FAULT} ended at generation "
          f"{shrunk['generation']} on {shrunk['n_hosts']} hosts, or its state "
          f"differs from the uninterrupted fit's")
    check(bool((ref["folds"] == ELASTIC_EPOCHS).all()),
          f"elastic: folds {ref['folds']}")
    ms_window = walls[1] / ELASTIC_WINDOWS * 1e3
    print(f"elastic_fit_local on {CARD}, {ELASTIC_WINDOWS} windows: 1, 2, 3 "
          f"hosts {walls[1]:.3f}, {walls[2]:.3f}, {walls[3]:.3f} s, bit-equal; "
          f"{ELASTIC_FAULT} (3 → 2 hosts, generation 1) {walls['fault']:.3f} "
          f"s, bit-equal; {ms_window:.2f} ms per window; inertia "
          f"{ref['inertia']}", flush=True)
    return ref, ms_window


def elastic_window_ms(run_dir, worker="0"):
    """Median milliseconds between one worker's consecutive ``window``
    records (the store exchange, the fold and the commit included)."""
    from sq_learn_tpu_torch.parallel import elastic

    ts = sorted(r["ts"] for r in elastic.collect_elastic_records(run_dir)
                if r["_worker"] == worker and r["event"] == "window")
    gaps = [b - a for a, b in zip(ts, ts[1:])]
    return statistics.median(gaps) * 1e3 if gaps else None


def elastic_world_case(S2, ref, tmp):
    """The real worlds: 2 workers uninterrupted, then 3 with worker 1
    SIGKILLed after the first commit; both results bit-equal to the
    simulator's. Returns the two runs' results and figures."""
    from sq_learn_tpu_torch.parallel import elastic

    out = {}
    for name, n, kill in (("two", 2, None), ("killed", 3, ELASTIC_KILL)):
        coord = elastic.ElasticCoordinator(
            os.path.join(tmp, f"run_{name}"), S2.path, n_workers=n,
            n_clusters=ELASTIC_K, seed=ELASTIC_SEED, epochs=ELASTIC_EPOCHS,
            window=ELASTIC_WINDOW, kill=kill)
        t0, launched = time.perf_counter(), time.time()
        try:
            got = coord.run(timeout_s=ELASTIC_TIMEOUT_S)
        except Exception:
            for i in range(n):
                log = os.path.join(coord.run_dir, f"worker{i}.log")
                if os.path.exists(log):
                    with open(log) as fh:
                        print(f"--- worker {i} log\n{fh.read()[-3000:]}",
                              flush=True)
            raise
        got["wall_s"] = time.perf_counter() - t0
        got["run_dir"] = coord.run_dir
        # the workers' start-up: launch to the last generation-0 world_up
        # (the process, torch, CUDA, the store, the gloo group and the
        # certification), on this host's one clock
        got["start_s"] = max(
            r["ts"] for r in elastic.collect_elastic_records(coord.run_dir)
            if r["event"] == "world_up" and r["generation"] == 0) - launched
        check(_same_fold(got, ref),
              f"elastic: the {n}-worker world's result differs from the "
              f"simulator's")
        check(bool((got["folds"] == ELASTIC_EPOCHS).all()),
              f"elastic: the {n}-worker world's folds {got['folds']}")
        check(got["launches"]["lloyd_step"] > 0,
              f"elastic: the {n}-worker world's certification launched "
              f"lloyd_step {got['launches']['lloyd_step']} times")
        out[name] = got
    two, killed = out["two"], out["killed"]
    check((two["generation"], two["n_hosts"], two["shrinks"]) == (0, 2, 0)
          and all(rc == 0 for rc in two["exit_codes"].values()),
          f"elastic: the 2-worker world ended at generation "
          f"{two['generation']} with exit codes {two['exit_codes']}")
    with open(os.path.join(killed["run_dir"], "manifest.g1.json")) as fh:
        members = json.load(fh)["members"]
    check((killed["generation"], killed["n_hosts"]) == (1, 2)
          and members == [0, 2] and killed["killed"] == [1]
          and killed["exit_codes"][1] == -9,
          f"elastic: the killed world ended at generation "
          f"{killed['generation']} on {killed['n_hosts']} hosts (members "
          f"{members}, exit codes {killed['exit_codes']})")
    records = elastic.collect_elastic_records(killed["run_dir"])
    fails = [r for r in records if r["event"] == "host_fail"
             and r.get("failed_host") == 1]
    check(fails and all(r.get("detect_s", 0) > 0 for r in fails),
          "elastic: no worker recorded host 1's failure with detect_s")
    ups = [r for r in records if r["event"] == "world_up"
           and r["generation"] == 1]
    check({r["_worker"] for r in ups} == {"0", "2"},
          f"elastic: generation 1 came up on {[r['_worker'] for r in ups]}")
    killed["detect_s"] = max(r["detect_s"] for r in fails)
    killed["shrink_s"] = max(r.get("shrink_s", 0.0) for r in ups)
    for got in (two, killed):
        got["ms_per_window"] = elastic_window_ms(got["run_dir"])
    print(f"elastic worlds: 2 workers {two['wall_s']:.3f} s (start-up "
          f"{two['start_s']:.3f} s), generation 0, bit-equal to the "
          f"simulator; 3 workers (start-up {killed['start_s']:.3f} s) with "
          f"worker 1 SIGKILLed "
          f"at cursor {ELASTIC_KILL[1]}: {killed['wall_s']:.3f} s, "
          f"generation 1 of members {members}, detection "
          f"{killed['detect_s']:.3f} s, abort → world up "
          f"{killed['shrink_s']:.3f} s, bit-equal to the simulator with "
          f"every shard folded {ELASTIC_EPOCHS} times; ms per window "
          f"{two['ms_per_window']:.2f} (2 workers), "
          f"{killed['ms_per_window']:.2f} (worker 0 of the killed world); "
          f"workers' lloyd_step launches {two['launches']['lloyd_step']} "
          f"and {killed['launches']['lloyd_step']}", flush=True)
    return two, killed


def elastic_fleet_case(run_dir, here):
    """``python -m sq_learn_tpu_torch.obs fleet`` over the killed world's
    shards: exit 0, one run id over the coordinator and the three
    workers, a monotone merged ``ts_fleet``, every committed window once,
    generation 1's critical path, the killed worker's fold progress, and
    every shard valid under the port's schema. Returns the summary."""
    from sq_learn_tpu_torch import _knobs
    from sq_learn_tpu_torch.obs import schema
    from sq_learn_tpu_torch.obs._files import load_jsonl

    merged = os.path.join(run_dir, "merged.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sq_learn_tpu_torch.obs", "fleet", run_dir,
         "--json", "--merged", merged], cwd=here, capture_output=True,
        text=True, timeout=120, env=_knobs.environ(PYTHONPATH=here))
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"elastic: obs fleet exited {proc.returncode}: {proc.stderr}")
    summary = json.loads(proc.stdout)
    check(len(summary["run_ids"]) == 1
          and summary["hosts"] == ["coord", "w0", "w1", "w2"],
          f"elastic: fleet run ids {summary['run_ids']} over hosts "
          f"{summary['hosts']}")
    ts = [r["ts_fleet"] for r in load_jsonl(merged)]
    check(ts == sorted(ts), "elastic: the merged ts_fleet is not monotone")
    # every process runs on this host, on one clock: the estimated
    # offsets must come out near 0 (the poll and heartbeat delays)
    skew = max(abs(o) for o in summary["clock_offsets_s"].values())
    check(skew <= ELASTIC_CLOCK_SKEW_S,
          f"elastic: clock offsets {summary['clock_offsets_s']} on one host")
    rc = summary["reconciliation"]
    check(rc["ok"] and rc["windows"] == rc["committed"] == ELASTIC_WINDOWS,
          f"elastic: commit reconciliation {rc}")
    path = [p for p in summary["critical_path"] if p["generation"] == 1]
    check(len(path) == 1 and all(
        path[0][key] is not None
        for key in ("detect_s", "shrink_s", "reinit_s", "resume_s")),
        f"elastic: generation 1's critical path {path}")
    w1 = summary["rollups"]["w1"]["by_type"]
    victim = [r for r in load_jsonl(os.path.join(run_dir, "obs.w1.jsonl"))
              if r.get("type") == "elastic" and r.get("event") == "window"]
    check(victim, f"elastic: the killed worker's shard holds no window "
                  f"record ({w1})")
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("obs.") and name.endswith(".jsonl"):
            errors = schema.validate_jsonl(os.path.join(run_dir, name))[
                "errors"]
            check(errors == [], f"elastic: {name}: {errors[:3]}")
    print(f"obs fleet over {summary['hosts']} ({summary['records']} records, "
          f"one run id, {cli_s:.3f} s): ledger OK, {rc['windows']} windows "
          f"committed once each; clock offsets within {skew:.6f} s of "
          f"the coordinator's; the killed worker's shard folded "
          f"{len(victim)} windows before its last flush; generation 1's "
          f"path {path[0]}", flush=True)
    return summary


def elastic_cert_entry(torch):
    """The Lloyd kernel at the certification's shard shape (4 rows × 5 of
    worker 0 in the 2-worker world, k=3, R=1, δ=0.4), held against its
    plain version and timed. Returns its shape entry."""
    import numpy as np

    rng = np.random.default_rng((ELASTIC_SEED, 0, 0xCE27))
    X = rng.normal(size=(8, 5)).astype(np.float32)
    Xs = torch.from_numpy(X[:4]).to(CARD)
    operands = lloyd_operands(Xs, 3, 1, torch)
    report = hold_lloyd_cases([("float32", Xs, operands["gum"], 0.4, True)],
                              operands, torch)
    main = report[("float32", 0.4)]
    return {"shape": "4x5 k=3 R=1 (elastic certification shard)",
            "window": 0.4, "launches": None,
            "max_abs_err": max(main["err"].values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"]}


def elastic_phase(here, torch):
    """The elastic phase (``sq_learn_tpu_torch.parallel.elastic``,
    ``obs.fleet``) in a temporary directory. Returns the ``elastic:``
    line's figures and the workers' Lloyd launches."""
    import shutil
    import tempfile

    from sq_learn_tpu_torch import oocore
    from sq_learn_tpu_torch.datasets import synthetic_surrogate

    tmp = tempfile.mkdtemp(prefix="sq-elastic-")
    try:
        X2, _ = synthetic_surrogate(OOC_S2_N, OOC_M, OOC_K, seed=OOC_SEED)
        S2 = oocore.store_from_array(os.path.join(tmp, "s2"), X2)
        del X2
        check(S2.n_shards == ooc_shards(OOC_S2_N),
              f"elastic: S2 has {S2.n_shards} shards")
        partial_ms, partial_cpu_ms = elastic_partial_case(S2, torch)
        ref, sim_ms = elastic_sim_case(S2)
        two, killed = elastic_world_case(S2, ref, tmp)
        summary = elastic_fleet_case(killed["run_dir"], here)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = (two["launches"]["lloyd_step"]
                + killed["launches"]["lloyd_step"])
    return {"shards": S2.n_shards, "windows": ELASTIC_WINDOWS,
            "clock_offsets_s": summary["clock_offsets_s"],
            "two_worker_fit_s": two["wall_s"],
            "killed_fit_s": killed["wall_s"],
            "two_worker_start_s": two["start_s"],
            "killed_start_s": killed["start_s"],
            "detect_s": killed["detect_s"], "shrink_s": killed["shrink_s"],
            "critical_path": [p for p in summary["critical_path"]
                              if p["generation"] == 1][0],
            "ms_per_window": two["ms_per_window"],
            "ms_per_window_killed": killed["ms_per_window"],
            "sim_ms_per_window": sim_ms, "partial_ms": partial_ms,
            "partial_cpu_ms": partial_cpu_ms,
            "worker_lloyd_launches": launches,
            "worker_argkmin_launches": (two["launches"]["argkmin"]
                                        + killed["launches"]["argkmin"])}


# ---------------------------------------------------------------------------
# BASELINE #1: q-means k=10 on sklearn's digits, read from the port's copy
# ---------------------------------------------------------------------------

DIGITS_N, DIGITS_M, DIGITS_K = 1797, 64, 10
#: X.sum() of the digits (float32), pinned on the CPU by
#: tests/test_torch_digits.py
DIGITS_X_SUM = 561718.0
#: timed fits after one warm-up; ``fit_s`` is their minimum
DIGITS_FITS = 3
DIGITS_SEEDS = (0, 1, 2)
#: floors from the port's CPU runs (tests/test_torch_digits.py): the
#: median ARI of the δ=0.5 fits of seeds 0–2 against the δ=0 fit of seed 0
#: is 0.98407 there, the lowest single seed of 0–7 0.97422, so the floor
#: sits 0.024 under the lowest; their median inertia ratio is 1.0000329,
#: the highest of seeds 0–7 1.000176, so the ceiling sits 0.0018 over it.
#: The card draws its Gumbel noise from another stream: the same law.
DIGITS_ARI_FLOOR = 0.95
DIGITS_INERTIA_CEIL = 1.002
DIGITS_INERTIA_RTOL = 1e-4  # δ=0 from one init, card against CPU
DIGITS_METRIC = "qkmeans_digits_1797x64_k10_fit_wallclock"  # bench.py's
DIGITS_PHASE_S = 30.0  # the digits phase's limit, seconds


def digits_fit(seed, delta=WINDOW, **kw):
    """BASELINE #1's estimator (``BASELINE.md`` row 1, ``bench.py``'s
    headline fit): QKMeans(n_clusters=10, n_init=10, max_iter=300,
    delta=0.5, true_distance_estimate=False, random_state=seed)."""
    from sq_learn_tpu_torch.models import QKMeans

    params = dict(n_clusters=DIGITS_K, n_init=10, max_iter=300, delta=delta,
                  true_distance_estimate=False, random_state=seed)
    return QKMeans(**{**params, **kw})


def digits_record(value, snap, backend):
    """BASELINE #1's metric line, in the JAX package's bench format."""
    return {"metric": DIGITS_METRIC, "value": value, "unit": "s",
            "backend": backend, "obs": snap}


def digits_regress(warmup, fresh, here):
    """``obs.regress.selftest(device="cuda")``, then ``python -m
    sq_learn_tpu_torch.obs regress`` on the phase's own record ``fresh``
    against a temp ``--root`` whose ``bench/records/`` holds the warm-up
    fit's record ``warmup``. Returns the selftest's verdicts and the CLI's
    summary."""
    import contextlib
    import io
    import shutil
    import tempfile

    from sq_learn_tpu_torch.obs import regress

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = regress.selftest(device="cuda")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0, f"obs.regress.selftest(device='cuda') returned {rc}: "
                   f"{out}")
    check(out["clean"]["peak_hbm_bytes"] == "green"
          and out["leaked"]["total_transfer_bytes"] == "red"
          and out["leaked"]["peak_hbm_bytes"] == "red",
          f"regress selftest verdicts {out}")
    root = tempfile.mkdtemp(prefix="sq_regress_")
    try:
        os.makedirs(os.path.join(root, "bench", "records"))
        with open(os.path.join(root, "bench", "records", "warmup.txt"),
                  "w") as fh:
            fh.write("# the digits phase's warm-up fit\n"
                     + json.dumps(warmup) + "\n")
        path = os.path.join(root, "fresh.txt")
        with open(path, "w") as fh:
            fh.write(json.dumps(fresh) + "\n")
        cli = subprocess.run(
            [sys.executable, "-m", "sq_learn_tpu_torch.obs", "regress", path,
             "--root", root], cwd=here, env=dict(os.environ, PYTHONPATH=here),
            capture_output=True, text=True, timeout=120)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lines = cli.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if lines else {}
    verdicts = {v["gate"]: v["verdict"]
                for v in map(json.loads, lines[:-1])}
    check(cli.returncode == 0
          and summary.get("regression_summary", {}).get("red") == 0
          and verdicts.get("peak_hbm_bytes") == "green",
          f"obs regress on the digits record exited {cli.returncode}: "
          f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    return {"selftest": {"clean": out["clean"], "leaked": out["leaked"],
                         "bytes": out["bytes"],
                         "peak_hbm_bytes": out["peak_hbm_bytes"]},
            "cli": verdicts, "cli_summary": summary["regression_summary"]}


def digits_phase(here, torch):
    """BASELINE #1 on the card: the digits through the port's
    ``load_digits``; the Lloyd kernel at 1797 × 64, k=10, R=10 against
    its plain version; the fit (one warm-up under obs, then the min of
    DIGITS_FITS timed fits), δ=0 on the card against the CPU from one
    init, the quality floors, and ``obs regress``. Returns the shape's
    entry for the kernels line (its launches filled in) and the
    ``digits:`` line's figures."""
    import warnings

    import numpy as np

    from sq_learn_tpu_torch import obs
    from sq_learn_tpu_torch.datasets import load_digits
    from sq_learn_tpu_torch.obs.regress import port_backend
    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    t_phase = time.perf_counter()
    X, y = load_digits()
    check(X.shape == (DIGITS_N, DIGITS_M) and X.dtype == np.float32
          and y.dtype == np.int32 and y.shape == (DIGITS_N,)
          and sorted(np.unique(y)) == list(range(DIGITS_K))
          and float(X.sum()) == DIGITS_X_SUM,
          f"load_digits: {X.shape} {X.dtype} {y.dtype}, sum {X.sum()}")
    # the kernel at the fit's shape, against its plain version (these
    # launches are comparisons: not counted)
    shape = lloyd_shape_phase(torch.from_numpy(X).to(CARD), DIGITS_K, torch)
    backend = port_backend(CARD)

    lloyd_step.launches = argkmin.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # δ=0's classic notice
        obs.enable()
        t0 = time.perf_counter()
        digits_fit(0).fit(X)
        warmup_s = time.perf_counter() - t0
        warmup = digits_record(warmup_s, obs.snapshot(), backend)
        obs.disable()
        fits, walls, launches = [], [], []
        for _ in range(DIGITS_FITS):
            before = lloyd_step.launches
            t0 = time.perf_counter()
            fits.append(digits_fit(0).fit(X))
            walls.append(time.perf_counter() - t0)
            launches.append(lloyd_step.launches - before)
        fit_s = min(walls)
        est = fits[0]
        check(all(np.array_equal(f.labels_, est.labels_) for f in fits),
              "BASELINE #1: the timed fits disagree")
        check(all(n > 0 for n in launches),
              f"BASELINE #1: a fit launched no Lloyd kernel: {launches}")
        check(np.isfinite(est.cluster_centers_).all()
              and est.cluster_centers_.shape == (DIGITS_K, DIGITS_M)
              and np.isfinite(est.inertia_) and est.n_iter_ >= 1,
              "BASELINE #1 fit output")
        # the record's obs: one more fit, with obs on
        obs.enable()
        digits_fit(0).fit(X)
        fresh = digits_record(fit_s, obs.snapshot(), backend)
        obs.disable()

        # δ=0 from one init, card against CPU: the classes' means (an
        # init of data rows ties exactly on these integer pixels)
        init = np.stack([X[y == c].mean(0) for c in range(DIGITS_K)])
        on = {device: digits_fit(0, delta=0.0, init=init, n_init=1,
                                 device=device).fit(X)
              for device in (CARD, "cpu")}
        card, cpu = on[CARD], on["cpu"]
        check(np.array_equal(card.labels_, cpu.labels_)
              and card.n_iter_ == cpu.n_iter_,
              f"BASELINE #1 δ=0: card (n_iter {card.n_iter_}) and CPU "
              f"(n_iter {cpu.n_iter_}) differ in "
              f"{int((card.labels_ != cpu.labels_).sum())} labels")
        check(np.isclose(card.inertia_, cpu.inertia_,
                         rtol=DIGITS_INERTIA_RTOL),
              f"BASELINE #1 δ=0: inertia {card.inertia_} against the CPU's "
              f"{cpu.inertia_}")

        # quality: δ=0.5 at three seeds against δ=0 at seed 0
        exact = digits_fit(0, delta=0.0).fit(X)
        quality = [est] + [digits_fit(s).fit(X) for s in DIGITS_SEEDS[1:]]
    aris = [ari(exact.labels_, f.labels_) for f in quality]
    ratios = [f.inertia_ / exact.inertia_ for f in quality]
    check(statistics.median(aris) >= DIGITS_ARI_FLOOR,
          f"BASELINE #1: median ARI {aris} < {DIGITS_ARI_FLOOR}")
    check(statistics.median(ratios) <= DIGITS_INERTIA_CEIL,
          f"BASELINE #1: median inertia ratio {ratios} > "
          f"{DIGITS_INERTIA_CEIL}")
    check(argkmin.launches == 0, "the digits phase launched argkmin")
    shape["launches"] = lloyd_step.launches

    gate = digits_regress(warmup, fresh, here)
    out = {"fit_s": fit_s, "fit_s_all": walls, "warmup_s": warmup_s,
           "n_iter": est.n_iter_, "inertia": float(est.inertia_),
           "launches_per_fit": launches, "launches": shape["launches"],
           "lloyd_ms": shape["ms"], "lloyd_plain_ms": shape["plain_ms"],
           "lloyd_bound_ms": shape["bound_ms"],
           "lloyd_bound_by": shape["bound_by"],
           "lloyd_window_0_ms": shape["window_0_ms"],
           "lloyd_window_0_plain_ms": shape["window_0_plain_ms"],
           "delta0_card_eq_cpu": True, "delta0_n_iter": cpu.n_iter_,
           "delta0_inertia_rel": abs(card.inertia_ - cpu.inertia_)
           / cpu.inertia_,
           "ari": aris, "ari_median": statistics.median(aris),
           "ari_floor": DIGITS_ARI_FLOOR, "inertia_ratio": ratios,
           "inertia_ratio_median": statistics.median(ratios),
           "inertia_ceiling": DIGITS_INERTIA_CEIL,
           "peak_hbm_bytes": fresh["obs"]["peak_hbm_bytes"], **gate}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"BASELINE #1 (digits 1797×64, k=10, δ=0.5): fit {fit_s:.4f} s "
          f"(min of {walls}; warm-up {warmup_s:.4f} s), n_iter "
          f"{est.n_iter_}, Lloyd launches per fit {launches}; median ARI "
          f"{out['ari_median']} against δ=0 (floor {DIGITS_ARI_FLOOR}), "
          f"median inertia ratio {out['inertia_ratio_median']} (ceiling "
          f"{DIGITS_INERTIA_CEIL}); δ=0 card == CPU (n_iter {cpu.n_iter_})",
          flush=True)
    check(out["phase_s"] < DIGITS_PHASE_S,
          f"the digits phase took {out['phase_s']} s, not under "
          f"{DIGITS_PHASE_S} s")
    return shape, out


# ---------------------------------------------------------------------------
# The examples phase: the reference's driver scripts (examples_torch/)
# ---------------------------------------------------------------------------

#: the drivers in the order they run, with their arguments: the JAX
#: drivers' defaults but for qpca_error_tradeoff (the Makefile's
#: ``examples`` arguments) and sharded_fit (four shards of the card);
#: runtime_tradeoff's ``--out`` goes to a temporary directory
EXAMPLES = (
    ("mnist_trial", ()),
    ("qpca_demo", ()),
    ("tomography_histogram", ()),
    ("delta_tradeoff", ()),
    ("qpca_error_tradeoff", ("--subsample", "4000", "--folds", "3")),
    ("runtime_tradeoff", ()),
    ("streaming_fit", ()),
    ("sharded_fit", ("--shards", str(MESH_SHARDS))),
)
EXAMPLES_PHASE_S = 120.0  # the phase's limit, seconds
# The JAX drivers' own numbers at the same arguments, measured on the CPU
# by the script modes of tests/test_torch_examples_qpca.py and
# tests/test_torch_examples_qkmeans.py; a floor is such a number less a
# stated margin.
#: mnist_trial's 10-fold 7-NN accuracy over 10 000 rows
EX_JAX_MNIST_CV = 1.0
#: qpca_error_tradeoff at --subsample 4000 --folds 3: per leg, (its
#: classical CV accuracy, {ε+δ: CV accuracy}) and its rows
EX_JAX_QERR = {
    "mnist": (1.0, {0.2: 1.0, 0.8: 1.0, 1.6: 1.0, 3.2: 1.0}),
    "low_margin": (0.9865, {0.2: 0.987, 0.8: 0.9742, 1.6: 0.9428,
                            3.2: 0.8755}),
    "cicids": (1.0, {0.2: 0.9998, 0.8: 0.951, 1.6: 0.8388, 3.2: 0.7137})}
EX_QERR_ROWS = {"mnist": 4000, "low_margin": 4000, "cicids": 4000}
#: tomography_histogram's P(err ≤ δ) over 64 trials, less three trials
EX_JAX_TOMO_WITHIN = 1.0
EX_TOMO_MARGIN = 3 / 64
#: delta_tradeoff's ARI range over random_state 0–9 at each δ; the δ=0
#: floor is its least less 0.005, the others' less 0.03
EX_JAX_SWEEP_ARI = {0.0: (1.0, 1.0), 0.1: (1.0, 1.0),
                    0.3: (0.9106336396931322, 0.9960908900559725),
                    0.5: (0.8068788074629861, 0.845357319176317),
                    1.0: (0.7701114062424389, 0.7996688268417864)}
EX_SWEEP_MARGIN = {0.0: 0.005, 0.1: 0.03, 0.3: 0.03, 0.5: 0.03, 1.0: 0.03}
#: runtime_tradeoff's leg-1 ARI range over random_state 0–11, less 0.01;
#: leg 2's holdout 1-NN accuracy over 1 536 queries
EX_JAX_RT_ARI = {0.0: (0.7724104510582867, 1.0),
                 2.0: (0.7724360514789496, 1.0),
                 8.0: (0.7724144511740647, 1.0),
                 32.0: (0.7724360514789496, 0.998438008626302)}
EX_RT_MARGIN = 0.01
EX_JAX_RT_ACC = {0.4: 1.0, 1.6: 1.0, 6.4: 1.0}
#: streaming_fit's mini-batch steps at the checkpoint and at the end
EX_STREAM_STEPS = (10, 20)
#: sharded_fit's exact 5-NN accuracy on 300 digits, less three digits;
#: its explained-variance ratio and σ₁ (no draw) at rtol 1e-4
EX_JAX_SHARDED = {"knn_accuracy": 0.990, "explained_variance_ratio": 0.8494,
                  "sigma1": 2193.1}
#: half a unit of the last digit the JAX driver prints of each
EX_SHARDED_PRINTED = {"explained_variance_ratio": 5e-5, "sigma1": 0.05}
EX_SHARDED_MARGIN = 3 / 300
EX_SHARDED_RTOL = 1e-4


def acc_floor(p, n):
    """The floor of an accuracy over ``n`` rows whose noise is a draw,
    against the JAX package's ``p``: 4 standard deviations of the
    difference of two binomial shares (p(1−p) floored at 1/n), and at
    least half a percent."""
    return p - max(4.0 * (2.0 * max(p * (1.0 - p), 1.0 / n) / n) ** 0.5,
                   0.005)


def load_example(here, name):
    """The module ``examples_torch/<name>.py`` under a name of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(here, "examples_torch",
                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(module, name, argv, torch):
    """Run one driver's ``main(argv + ['--device', <CARD's type>])`` with
    the kernels' counts at 0; its printed lines are echoed indented.
    Returns its result, seconds, Lloyd and argkmin launches and argkmin
    launches by (width, k)."""
    import contextlib
    import io

    from sq_learn_tpu_torch.ops.kernels import argkmin, lloyd_step

    buf = io.StringIO()
    lloyd_step.launches = argkmin.launches = 0
    argkmin.by_shape.clear()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            result = module.main([*argv, "--device",
                                  torch.device(CARD).type])
        torch.cuda.synchronize()
    except SystemExit as exc:
        raise RuntimeError(f"chip_smoke: examples_torch/{name}.py exited: "
                           f"{exc.code}") from None
    finally:
        print("".join(f"  | {line}\n" for line in
                      buf.getvalue().splitlines()), end="", flush=True)
    return {"result": result, "s": time.perf_counter() - t0,
            "lloyd_launches": lloyd_step.launches,
            "argkmin_launches": argkmin.launches,
            "by_shape": dict(argkmin.by_shape)}


def examples_phase(here, torch):
    """Every driver of ``examples_torch/`` in-process on the card at the
    arguments of EXAMPLES, each with the kernels' counts set to 0 before
    it: the quality floors against the JAX drivers' own numbers, the
    resumed stream bit-equal to one uninterrupted ingest, and the kernels
    held against their plain versions at the shapes the drivers launch
    them at. Returns the Lloyd and argkmin shape entries (launches filled
    in) and the ``examples:`` line's figures."""
    import tempfile
    import warnings

    import numpy as np

    t_phase = time.perf_counter()
    modules = {name: load_example(here, name) for name, _ in EXAMPLES}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in EXAMPLES:
            if name == "runtime_tradeoff":
                argv = ("--out", os.path.join(tmp, "tradeoff.jsonl"))
            print(f"examples_torch/{name}.py {' '.join(argv)} --device "
                  f"{torch.device(CARD).type}", flush=True)
            runs[name] = run_example(modules[name], name, argv, torch)
        cards = torch.cuda.device_count()
        if cards > 1:  # sharded_fit over the real cards too
            print(f"examples_torch/sharded_fit.py --device cuda ({cards} "
                  f"cards)", flush=True)
            runs["sharded_fit_cards"] = run_example(
                modules["sharded_fit"], "sharded_fit", (), torch)
    res = {name: run["result"] for name, run in runs.items()}
    launches = {name: (run["lloyd_launches"], run["argkmin_launches"])
                for name, run in runs.items()}

    # which drivers launch which kernel
    expect = {"mnist_trial": (False, True), "qpca_demo": (False, False),
              "tomography_histogram": (False, False),
              "delta_tradeoff": (True, False),
              "qpca_error_tradeoff": (False, True),
              "runtime_tradeoff": (True, True),
              "streaming_fit": (False, False),
              "sharded_fit": (True, True), "sharded_fit_cards": (True, True)}
    for name, (lloyd_n, knn_n) in launches.items():
        want_lloyd, want_knn = expect[name]
        check((lloyd_n > 0) == want_lloyd and (knn_n > 0) == want_knn,
              f"examples_torch/{name}.py launched lloyd_step {lloyd_n} and "
              f"argkmin {knn_n} times")
    check(launches["mnist_trial"][1] == 10,
          f"mnist_trial's 10-fold CV launched argkmin "
          f"{launches['mnist_trial'][1]} times")

    # quality floors
    mnist = res["mnist_trial"]
    check(mnist["shape"] == (10_000, M) and mnist["topk"] == 61
          and np.isfinite(mnist["f_norm"]),
          f"mnist_trial: shape {mnist['shape']}, top-k {mnist['topk']}")
    check(mnist["cv_mean"] >= acc_floor(EX_JAX_MNIST_CV, 10_000),
          f"mnist_trial: CV accuracy {mnist['cv_mean']} under "
          f"{acc_floor(EX_JAX_MNIST_CV, 10_000)}")
    for leg, (classical, points) in EX_JAX_QERR.items():
        got, n = res["qpca_error_tradeoff"][leg], EX_QERR_ROWS[leg]
        check(got["classical_acc"] >= acc_floor(classical, n),
              f"qpca_error_tradeoff {leg}: classical CV accuracy "
              f"{got['classical_acc']} under {acc_floor(classical, n)}")
        for err, acc in points.items():
            mine = got["points"][err]
            check(mine["acc"] >= acc_floor(acc, n)
                  and np.isfinite(mine["f_norm"]),
                  f"qpca_error_tradeoff {leg} ε+δ={err}: CV accuracy "
                  f"{mine['acc']} under {acc_floor(acc, n)}")
    tomo = res["tomography_histogram"]
    check(tomo["within"] >= EX_JAX_TOMO_WITHIN - EX_TOMO_MARGIN,
          f"tomography_histogram: P(err <= delta) {tomo['within']} under "
          f"{EX_JAX_TOMO_WITHIN - EX_TOMO_MARGIN}")
    sweep = res["delta_tradeoff"]
    check(sweep["shape"] == (20_000, SWEEP_M) and sweep["k"] == SWEEP_K,
          f"delta_tradeoff: shape {sweep['shape']}, k {sweep['k']}")
    check(sweep["sklearn_ari"] is None or sweep["sklearn_ari"] >= 0.99,
          f"delta_tradeoff: sklearn's ARI {sweep['sklearn_ari']}")
    for delta, (lo, _) in EX_JAX_SWEEP_ARI.items():
        got = sweep["sweep"][delta]["ari"]
        check(got >= lo - EX_SWEEP_MARGIN[delta],
              f"delta_tradeoff δ={delta}: ARI {got} under "
              f"{lo - EX_SWEEP_MARGIN[delta]}")
    rt = res["runtime_tradeoff"]
    check(rt["flagged"] == [], f"runtime_tradeoff flagged {rt['flagged']}")
    for delta, (lo, _) in EX_JAX_RT_ARI.items():
        got = rt["qkmeans"][delta]
        check(got["ari"] >= lo - EX_RT_MARGIN
              and (delta == 0 or got["q_runtime"] > 0),
              f"runtime_tradeoff δ={delta}: {got} under ARI "
              f"{lo - EX_RT_MARGIN}")
    for err, acc in EX_JAX_RT_ACC.items():
        got = rt["qpca"][err]
        check(got["acc"] >= acc_floor(acc, 1536) and got["q_runtime"] > 0,
              f"runtime_tradeoff ε+δ={err}: {got} under accuracy "
              f"{acc_floor(acc, 1536)}")
    stream = res["streaming_fit"]
    check((stream["saved_steps"], stream["n_steps"]) == EX_STREAM_STEPS,
          f"streaming_fit: steps {stream['saved_steps']} and "
          f"{stream['n_steps']}, not {EX_STREAM_STEPS}")
    stream_eq = stream_resume_case(modules["streaming_fit"], stream)
    for name in ("sharded_fit", "sharded_fit_cards"):
        if name not in res:
            continue
        got = res[name]
        check(got["knn_accuracy"] >= EX_JAX_SHARDED["knn_accuracy"]
              - EX_SHARDED_MARGIN and got["clusters"] == 5
              and got["transform_shape"] == (64, 16),
              f"{name}: {got} against {EX_JAX_SHARDED}")
        for key, half_unit in EX_SHARDED_PRINTED.items():
            check(abs(got[key] - EX_JAX_SHARDED[key])
                  <= EX_SHARDED_RTOL * EX_JAX_SHARDED[key] + half_unit,
                  f"{name}: {key} {got[key]} against the JAX driver's "
                  f"{EX_JAX_SHARDED[key]}")

    # the kernels at the shapes the drivers launch them at (these
    # launches are comparisons: not counted)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lloyd_entries, knn_entries = example_kernel_shapes(runs, torch)
    out = {"phase_s": time.perf_counter() - t_phase,
           "stream_resume_bit_equal": stream_eq,
           "drivers": {name: {key: run[key] for key in (
               "s", "lloyd_launches", "argkmin_launches")}
                       for name, run in runs.items()},
           "mnist_cv": mnist["cv_mean"], "mnist_f_norm": mnist["f_norm"],
           "demo_topk": res["qpca_demo"]["topk"],
           "demo_est_theta": res["qpca_demo"]["est_theta"],
           "tomography_within": tomo["within"],
           "tomography_mean_err": tomo["mean_err"],
           "sweep_ari": {d: p["ari"] for d, p in sweep["sweep"].items()},
           "sweep_fit_s": {d: p["fit_s"] for d, p in sweep["sweep"].items()},
           "qerr_acc": {leg: {e: p["acc"]
                              for e, p in v["points"].items()}
                        for leg, v in res["qpca_error_tradeoff"].items()},
           "runtime_ari": {d: p["ari"] for d, p in rt["qkmeans"].items()},
           "runtime_acc": {e: p["acc"] for e, p in rt["qpca"].items()},
           "runtime_draws": rt["draws"],
           "stream_steps": stream["n_steps"],
           "stream_inertia": stream["inertia"],
           "sharded_knn": res["sharded_fit"]["knn_accuracy"],
           "sharded_inertia": res["sharded_fit"]["inertia"]}
    check(out["phase_s"] < EXAMPLES_PHASE_S,
          f"the examples phase took {out['phase_s']} s, not under "
          f"{EXAMPLES_PHASE_S} s")
    return lloyd_entries, knn_entries, out


def stream_resume_case(module, stream):
    """streaming_fit's resumed ingest against one uninterrupted ingest
    of the same file on the card: the same centers, inertia and steps,
    bit for bit."""
    import tempfile
    import warnings

    import numpy as np

    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = os.path.join(tmp, "events.csv")
        module.write_events(path)
        est = module.new_estimator()
        for batch in module.csv_stream_batches(path, batch_rows=1024):
            est.partial_fit(batch)
    same = (est.n_steps_ == stream["n_steps"]
            and np.array_equal(est.cluster_centers_, stream["centers"])
            and est.inertia_ == stream["inertia"])
    check(same, f"streaming_fit: the resumed stream ({stream['n_steps']} "
                f"steps, inertia {stream['inertia']}) is not bit-equal to "
                f"one ingest ({est.n_steps_} steps, inertia {est.inertia_})")
    print(f"streaming_fit: the resumed stream bit-equal to one "
          f"uninterrupted ingest of the file ({est.n_steps_} steps)",
          flush=True)
    return same


def example_kernel_shapes(runs, torch):
    """Both kernels held against their plain versions, and timed, at the
    drivers' shapes: Lloyd at delta_tradeoff's 20 000 × 78 (k=6, R=10),
    runtime_tradeoff's 3 072 × 32 (k=6, R=2) and a shard of sharded_fit's
    4 003 blobs (1 001 × 16, k=5, R=1); argkmin at mnist_trial's folds
    (9 000 × 1 000 × 61, k=7), qpca_error_tradeoff's folds (2 666 × 1 334
    at width 61 for its MNIST legs and 10 for its CICIDS leg, k=7),
    runtime_tradeoff's holdout (1 536 × 1 536 × 8, k=1) and a shard of
    sharded_fit's 5-NN (450 × 300 × 64, k=5). ``runs`` holds the drivers'
    runs (:func:`run_example`). Returns the entries, each with its
    driver's launches (at that (width, k) for the search)."""
    import numpy as np

    from sq_learn_tpu_torch.datasets import (load_cicids, load_digits,
                                             load_mnist, make_blobs)
    from sq_learn_tpu_torch.models import QPCA
    from sq_learn_tpu_torch.preprocessing import StandardScaler

    X, _, _ = load_mnist()
    Xc, _, _ = load_cicids(n_samples=20_000)
    Xs = StandardScaler().fit_transform(Xc)
    rng = np.random.default_rng(0)  # runtime_tradeoff's clustered rows
    centers = rng.normal(scale=1.6, size=(6, 32))
    Xrt = np.concatenate([rng.normal(loc=c, scale=1.0, size=(512, 32))
                          for c in centers]).astype(np.float32)
    Xrt = Xrt[rng.permutation(len(Xrt))]
    Xb, _ = make_blobs(n_samples=4003, centers=5, n_features=16,
                       random_state=0)
    Xd, _ = load_digits()

    lloyd = []
    for name, rows, k, r in (("delta_tradeoff", Xs, 6, R),
                             ("runtime_tradeoff",
                              torch.from_numpy(Xrt).to(CARD), 6, 2),
                             ("sharded_fit",
                              torch.from_numpy(Xb[:1001]).to(CARD), 5, 1)):
        entry = lloyd_shape_phase(rows, k, torch, r=r)
        entry["launches"] = runs[name]["lloyd_launches"]
        entry["driver"] = name
        lloyd.append(entry)

    def projected(Z, width):
        pca = QPCA(n_components=width, svd_solver="full",
                   random_state=0).fit(Z)
        return pca.transform(Z).contiguous()

    Zm = projected(X[:10_000], 61)
    Zq = projected(X[:4000], 61)
    Zc = projected(StandardScaler().fit_transform(Xc[:4000]), 10)
    Zr = projected(Xrt, 8)
    Zd = torch.from_numpy(Xd).to(CARD)
    knn = []
    for name, T, Q, k, key in (
            ("mnist_trial", Zm[:9000], Zm[9000:], 7, "mnist_trial"),
            ("qpca_error_tradeoff's MNIST legs", Zq[:2666], Zq[2666:], 7,
             "qpca_error_tradeoff"),
            ("qpca_error_tradeoff's CICIDS leg", Zc[:2666], Zc[2666:], 7,
             "qpca_error_tradeoff"),
            ("runtime_tradeoff", Zr[:1536], Zr[1536:], 1,
             "runtime_tradeoff"),
            ("sharded_fit", Zd[:450], Zd[:300], 5, "sharded_fit")):
        T, Q = T.contiguous(), Q.contiguous()
        entry = argkmin_fold_case(
            T, torch.sum(T * T, dim=1), Q, k,
            runs[key]["by_shape"].get((T.shape[1], k), 0), torch,
            path=name)
        entry["driver"] = key
        knn.append(entry)
    return lloyd, knn


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
    entry, lloyd_ops = kernel_phase(Xc, torch)
    print("library_ms: null — no single PyTorch call computes the fused "
          "Lloyd step (distances, δ-window pick and weighted partial sums)",
          flush=True)
    knn_entry = argkmin_phase(Xd, torch)
    print("argkmin library_ms: null — no single PyTorch call computes a "
          "k-smallest search with lowest-index ties (torch.topk leaves the "
          "order of ties undocumented)", flush=True)
    # the profiling phase's kernel part (its fit comes after every main
    # path): benchmark and trace launches, counted in its own line only
    profiling = profiling_phase(Xc, Xd, lloyd_ops, entry["ms"],
                                knn_entry["ms"], smi, here, torch)
    del lloyd_ops

    # phase 3: the main path through the entry points a user calls
    est = QKMeans(n_clusters=K, n_init=10, max_iter=300, delta=WINDOW,
                  true_distance_estimate=False, sketch=0, random_state=0)
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    est.fit(X)
    fit_s = time.perf_counter() - t0
    entry["launches"] = lloyd_step.launches
    check(entry["launches"] > 0, "the δ-means fit never launched the kernel")
    check(est.ingest_ == "streamed",
          f"BASELINE #3's fit of {X.nbytes} host bytes under 'auto' did not "
          f"stream (ingest_ {est.ingest_})")
    check(np.isfinite(est.cluster_centers_).all()
          and np.isfinite(est.inertia_), "δ-means fit is not finite")
    check(est.cluster_centers_.shape == (K, M), "centers of the wrong shape")
    check(est.n_iter_ >= 1, "δ-means fit ran no iteration")
    fit_ari = ari(y, est.labels_)
    check(fit_ari >= ARI_FLOOR, f"δ-means ARI {fit_ari} < {ARI_FLOOR}")
    # κ of the exact route against the float64 Gram of the same X
    X64 = Xd.double()
    kappa64 = 1.0 / float(torch.linalg.eigvalsh(X64.T @ X64)[0]) ** 0.5
    del X64
    kappa_rel = abs(est.condition_number_ - kappa64) / kappa64
    check(kappa_rel <= EXACT_KAPPA_RTOL,
          f"δ-means fit: κ {est.condition_number_} against float64 "
          f"{kappa64}, relative error {kappa_rel} > {EXACT_KAPPA_RTOL}")
    print(f"QKMeans δ=0.5 δ-means fit: {fit_s:.3f} s, n_iter {est.n_iter_}, "
          f"inertia {est.inertia_}, ARI {fit_ari}, kernel launches "
          f"{entry['launches']}, eta {est.eta_}, mu {est.mu_} "
          f"({est.norm_mu_}), kappa {est.condition_number_} against float64 "
          f"{kappa64} (relative {kappa_rel}, limit {EXACT_KAPPA_RTOL})",
          flush=True)
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
    t0 = time.perf_counter()
    streamed_pred = classic.predict(X)  # host rows above the cap: streamed
    stream_pred_s = time.perf_counter() - t0
    check(np.array_equal(streamed_pred, classic.labels_),
          "δ=0 predict ≠ fit labels")
    t0 = time.perf_counter()
    check(np.array_equal(classic.predict(Xd), streamed_pred),
          "δ=0 streamed predict ≠ the monolithic predict of the card tensor")
    print(f"δ=0 predict of the host rows (streamed, {stream_pred_s:.4f} s) "
          f"bit-equal to the predict of the card tensor "
          f"({time.perf_counter() - t0:.4f} s) and to the fit's labels",
          flush=True)
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

    # path A, q-means at the reference's defaults: no kernel launch
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    qkmeans_ipe_path(X, y, Xd, torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          f"path A launched lloyd_step {lloyd_step.launches} and argkmin "
          f"{argkmin.launches} times")
    print(f"path A: {time.perf_counter() - t0:.3f} s", flush=True)
    # path B, δ-means with tomography of the centers: its Lloyd launches
    # are added to the kernel's
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    tomo_launches = qkmeans_tomography_path(X, y, torch)
    check(tomo_launches > 0 and argkmin.launches == 0,
          f"path B launched lloyd_step {tomo_launches} and argkmin "
          f"{argkmin.launches} times")
    entry["launches"] += tomo_launches
    print(f"path B: {time.perf_counter() - t0:.3f} s", flush=True)

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

    # the qPCA trial, its argkmin launches counted from 0 and added to the
    # k-NN path's
    multinomial_tree(torch)
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    trial_launches, pca = qpca_trial_path(X, y, torch)
    check(trial_launches == 10 and lloyd_step.launches == 0,
          f"the qPCA trial launched argkmin {trial_launches} and "
          f"lloyd_step {lloyd_step.launches} times")
    knn_entry["launches"] += trial_launches
    print(f"qPCA trial path: {time.perf_counter() - t0:.3f} s, argkmin "
          f"launches {trial_launches}", flush=True)
    # path C, the runtime model of the trial's fitted QPCA
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    qpca_runtime_path(pca)
    check(lloyd_step.launches == argkmin.launches == 0,
          "path C launched a kernel")
    print(f"path C: {time.perf_counter() - t0:.3f} s", flush=True)
    qpca_card_vs_cpu()
    # path D, QLSSVC: no kernel launch
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    qlssvc_path(X, y, torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          "path D launched a kernel")
    print(f"path D: {time.perf_counter() - t0:.3f} s", flush=True)

    # BASELINE #5's data, standardized on the card once for the Lloyd
    # kernel's phase at its shape and for the δ-sweep
    Xsweep, ysweep, scale_s = cicids_standardized(torch)
    print(f"load_cicids({SWEEP_N}) surrogate, StandardScaler on the card "
          f"{scale_s:.4f} s", flush=True)
    # the Lloyd kernel at the δ-sweep's shape, against its plain version
    t0 = time.perf_counter()
    sweep_entry = lloyd_shape_phase(Xsweep, SWEEP_K, torch)
    print(f"Lloyd kernel phase at {sweep_entry['shape']}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    # BASELINE #5, the δ-sweep: its Lloyd launches join the kernel's
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    sweep_entry["launches"], sweep = delta_sweep_path(Xsweep, ysweep, torch)
    check(argkmin.launches == 0, "the δ-sweep launched argkmin")
    entry["launches"] += sweep_entry["launches"]
    entry["shapes"] = [sweep_entry]
    print(f"δ-sweep path: {time.perf_counter() - t0:.3f} s, lloyd_step "
          f"launches {sweep_entry['launches']}, argkmin launches "
          f"{argkmin.launches}", flush=True)
    # the accuracy-vs-quantum-runtime study, with obs on: its Lloyd
    # launches (leg 1) and argkmin launches (leg 2) join the kernels'
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    tradeoff_lloyd, tradeoff_knn, tradeoff_shape = tradeoff_phase(
        Xsweep, ysweep, sweep, here, torch)
    entry["launches"] += tradeoff_lloyd
    knn_entry["launches"] += tradeoff_knn
    print(f"trade-off path: {time.perf_counter() - t0:.3f} s, lloyd_step "
          f"launches {tradeoff_lloyd}, argkmin launches {tradeoff_knn}",
          flush=True)
    # BASELINE #4, TruncatedSVD: no kernel launch
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    svd, Xcov = truncated_svd_path(torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          "the TruncatedSVD path launched a kernel")
    print(f"TruncatedSVD path: {time.perf_counter() - t0:.3f} s, lloyd_step "
          f"launches {lloyd_step.launches}, argkmin launches "
          f"{argkmin.launches}", flush=True)
    # the error-budget grid search: its argkmin launches join the kernel's
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    grid_launches, grid_by_shape = grid_search_path(X, y, torch)
    check(lloyd_step.launches == 0, "the grid search launched lloyd_step")
    knn_entry["launches"] += grid_launches
    print(f"grid search path: {time.perf_counter() - t0:.3f} s, argkmin "
          f"launches {grid_launches}, lloyd_step launches "
          f"{lloyd_step.launches}", flush=True)
    t0 = time.perf_counter()
    knn_entry["shapes"] = (argkmin_fold_phase(X, grid_by_shape, torch)
                           + [tradeoff_shape])
    print(f"argkmin fold-shape phase: {time.perf_counter() - t0:.3f} s",
          flush=True)
    # mini-batch q-means: plain torch steps, no kernel launch
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    minibatch_path(X, y, classic.inertia_, torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          "the mini-batch path launched a kernel")
    print(f"mini-batch path: {time.perf_counter() - t0:.3f} s, lloyd_step "
          f"launches {lloyd_step.launches}, argkmin launches "
          f"{argkmin.launches}", flush=True)
    lloyd_step.launches = argkmin.launches = 0
    t0 = time.perf_counter()
    hasher_path(torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          "the hasher launched a kernel")
    print(f"FeatureHasher path: {time.perf_counter() - t0:.3f} s, "
          f"lloyd_step launches {lloyd_step.launches}, argkmin launches "
          f"{argkmin.launches}", flush=True)

    # the streaming phase: streamed ingest, faults, checkpoints and item
    # 7's routes, each path with the counts set to 0 before it
    t_phase = time.perf_counter()
    rates = resident_put_case(X, torch)
    lloyd_step.launches = argkmin.launches = 0
    streamed_qpca_case(X, Xd, torch)
    breaker_case(X, torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          "the streamed qPCA cases launched a kernel")
    stream_knn, tile_entry = streamed_knn_case(X, y, Xd, torch)
    knn_entry["launches"] += stream_knn
    knn_entry["shapes"].append(tile_entry)
    lloyd_step.launches = argkmin.launches = 0
    checkpoint_case(est, pca, X, y, Xd, Xsweep, ysweep, torch)
    check(lloyd_step.launches == 0, "the checkpoint case launched lloyd_step")
    knn_entry["launches"] += argkmin.launches
    lloyd_step.launches = argkmin.launches = 0
    entry["launches"] += item7_case(X, y, Xd, classic, torch)
    print(f"streaming phase: {time.perf_counter() - t_phase:.3f} s "
          f"(resident put GB/s {rates})", flush=True)

    # the out-of-core phase: shard stores, the store-backed fits, resume,
    # the codec and obs; the labelling pass's Lloyd launches join the
    # kernel's
    lloyd_step.launches = argkmin.launches = 0
    t_phase = time.perf_counter()
    ooc_entry = oocore_phase(here, torch)
    check(argkmin.launches == 0, "the out-of-core phase launched argkmin")
    entry["launches"] += lloyd_step.launches
    entry["shapes"].append(ooc_entry)
    print(f"out-of-core phase: {time.perf_counter() - t_phase:.3f} s",
          flush=True)

    # the serving phase: the serving kernels are plain torch, so neither
    # hand-written kernel may launch in it
    lloyd_step.launches = argkmin.launches = 0
    t_phase = time.perf_counter()
    serving = serving_phase({"alpha": classic, "gamma": pca, "delta": svd},
                            streamed_pred, X, Xcov, on["cpu"], here, torch)
    check(lloyd_step.launches == argkmin.launches == 0,
          f"the serving phase launched lloyd_step {lloyd_step.launches} and "
          f"argkmin {argkmin.launches} times")
    serving["phase_s"] = time.perf_counter() - t_phase
    print(f"serving phase: {serving['phase_s']:.3f} s", flush=True)
    print("serving: " + json.dumps(serving), flush=True)

    # the mesh phase: both kernels at the shard shapes first, then the
    # sharded paths with the counts set to 0; their launches join the
    # kernels'
    t_phase = time.perf_counter()
    mesh_lloyd, mesh_knn = mesh_kernel_shapes(Xc, Xd, torch)
    lloyd_step.launches = argkmin.launches = 0
    tally = mesh_phase(X, y, est, Xcov, torch)
    mesh_lloyd["launches"], mesh_knn["launches"] = tally[MESH_SHARDS]
    check(mesh_lloyd["launches"] > 0 and mesh_knn["launches"] > 0,
          f"the {MESH_SHARDS}-shard mesh runs launched lloyd_step "
          f"{mesh_lloyd['launches']} and argkmin {mesh_knn['launches']} "
          f"times")
    # the single-device and 1-shard runs launch at the main shapes, and a
    # mesh over a card count other than MESH_SHARDS at shapes with no
    # entry: those join only the kernels' totals
    entry["launches"] += lloyd_step.launches
    knn_entry["launches"] += argkmin.launches
    entry["shapes"].append(mesh_lloyd)
    knn_entry["shapes"].append(mesh_knn)
    print(f"mesh phase: {time.perf_counter() - t_phase:.3f} s; launches "
          f"(lloyd_step, argkmin) by shard count: "
          f"{ {n: tuple(t) for n, t in sorted(tally.items())} }",
          flush=True)

    # the elastic phase: the fold's partials run in plain torch and the
    # workers' certification launches the Lloyd kernel in their own
    # processes, which report their counts; they join the kernel's
    lloyd_step.launches = argkmin.launches = 0
    t_phase = time.perf_counter()
    cert_entry = elastic_cert_entry(torch)
    lloyd_step.launches = argkmin.launches = 0
    elastic = elastic_phase(here, torch)
    check(lloyd_step.launches == argkmin.launches == 0
          and elastic["worker_argkmin_launches"] == 0,
          f"the elastic phase launched lloyd_step {lloyd_step.launches} and "
          f"argkmin {argkmin.launches} times in this process, argkmin "
          f"{elastic['worker_argkmin_launches']} times in its workers")
    cert_entry["launches"] = elastic["worker_lloyd_launches"]
    entry["launches"] += elastic["worker_lloyd_launches"]
    entry["shapes"].append(cert_entry)
    elastic["phase_s"] = time.perf_counter() - t_phase
    print(f"elastic phase: {elastic['phase_s']:.3f} s", flush=True)
    print("elastic: " + json.dumps(elastic), flush=True)

    # the digits phase: BASELINE #1 on the card, its Lloyd launches at a
    # shape of their own joining the kernel's
    digits_entry, digits = digits_phase(here, torch)
    entry["launches"] += digits_entry["launches"]
    entry["shapes"].append(digits_entry)
    print(f"digits phase: {digits['phase_s']:.3f} s", flush=True)
    print("digits: " + json.dumps(digits), flush=True)

    # the examples phase: every driver of examples_torch/ on the card,
    # each with the counts set to 0 before it; their launches join the
    # kernels', filed under the drivers' shapes
    ex_lloyd, ex_knn, examples = examples_phase(here, torch)
    entry["launches"] += sum(d["lloyd_launches"]
                             for d in examples["drivers"].values())
    knn_entry["launches"] += sum(d["argkmin_launches"]
                                 for d in examples["drivers"].values())
    entry["shapes"].extend(ex_lloyd)
    knn_entry["shapes"].extend(ex_knn)
    print(f"examples phase: {examples['phase_s']:.3f} s", flush=True)
    print("examples: " + json.dumps(examples), flush=True)

    # the profiling phase's fit: a main-path run whose launches join
    lloyd_step.launches = argkmin.launches = 0
    entry["launches"] += profiling_fit(X, profiling, here)
    check(argkmin.launches == 0, f"the profiling fit launched argkmin "
                                 f"{argkmin.launches} times")
    print(f"profiling phase: {profiling['phase_s']:.3f} s", flush=True)
    print("profiling: " + json.dumps(profiling), flush=True)
    print(smi)
    print(json.dumps({"kernels": [entry, knn_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world-worker"]:
        sys.exit(world_worker(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5],
                              os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
